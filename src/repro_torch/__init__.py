"""PyTorch / CUDA port of the HERO reproduction, for NVIDIA Hopper.

Mirrors the module paths of the JAX package (`repro_torch.nerf.fast_render`
<-> `repro.nerf.fast_render`) and imports nothing from it: the JAX package is
the reference this port is held against by the `tests/test_torch_*` parity
tests. Every Pallas kernel on the serving path has a hand-written CUDA
counterpart under `csrc/`, reached through `repro_torch.kernels.ops`, which
dispatches by the tensor's device (CUDA tensor -> kernel, CPU tensor -> the
kernel's plain PyTorch version).
"""
