"""Inputs and the plain reference of the MSM benchmark.

Imports torch and numpy only: nothing of the program under test, nothing
of the JAX package. `curve.py` holds frozen copies of the curve's
constants and a slow Python-int model; `field.py` the limb arithmetic that
makes the inputs on the card; `inputs.py` the points (distinct, with
known discrete logs) and scalars; `expected.py` the exact results.
"""
