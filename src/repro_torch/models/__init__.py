"""The port's model stack (plain PyTorch): the dense GQA transformer that the
serving engine runs.  The other families of the reference (MoE, Mamba-2,
RWKV-6, hybrid, enc-dec, VLM) are not ported yet (ROADMAP A12-A13)."""
from . import convert, layers, transformer  # noqa: F401
