from . import evaluation, synthetic

__all__ = ["evaluation", "synthetic"]
