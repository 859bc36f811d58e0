from .timing import Timer

__all__ = ["Timer"]
