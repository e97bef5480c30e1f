"""Several processes over `torch.distributed`: one process per card, joined
in a process group (`comm`), started by `launch`; `mesh.pad_to_multiple`."""

from . import comm
from .mesh import pad_to_multiple

__all__ = ["comm", "pad_to_multiple"]
