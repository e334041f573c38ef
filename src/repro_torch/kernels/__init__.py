"""Hand-written Hopper kernels, their plain PyTorch versions, and the
device-dispatching entry points (`ops`)."""
