import torch

# One thread a process: the plain versions run many small ops, and several
# test workers each forking a thread per core for every op run far slower.
torch.set_num_threads(1)
