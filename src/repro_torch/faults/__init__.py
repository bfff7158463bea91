from .errors import CapacityError, FaultError

__all__ = ["CapacityError", "FaultError"]
