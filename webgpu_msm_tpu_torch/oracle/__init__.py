"""Host-side correctness oracle: exact bigint field, curve and MSM code."""
