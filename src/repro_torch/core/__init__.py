from repro_torch.core.errors import DoubleFreeError, UnknownRequestError

__all__ = ["DoubleFreeError", "UnknownRequestError"]
