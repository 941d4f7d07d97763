"""Device resolution for the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """None means the GPU: raise when there is none, rather than run
    somewhere else.  Any explicit device (tests pass "cpu") is taken as
    given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: firedancer_tpu_torch runs on the GPU unless "
                "a device is given (device='cpu' runs the plain versions)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
