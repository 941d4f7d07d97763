"""PyTorch/CUDA port of firedancer_tpu: the strict and the RLC batch
ed25519 sigverify serving paths on an NVIDIA H100 (hand-written CUDA
kernels in csrc/, their plain torch versions beside them in ops/)."""

from ._device import resolve_device

__all__ = ["resolve_device"]
