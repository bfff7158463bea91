"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.
The EnCodec frontend is stubbed: input_specs provides precomputed frame
embeddings (assignment rule for [audio] entries).  Positional encoding is
RoPE here (the published model uses sinusoidal embeddings — noted in
DESIGN.md as a TPU-stack adaptation; the backbone dims are exact)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    mlp_kind="gelu",
    input_mode="embeds",
)
