"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-3B].

28L d_model=3072 24H (kv=8) d_ff=8192 vocab=128256.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="llama3.2-3b",
    model=ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=128256,
        mlp_kind="swiglu",
        norm="rms",
        use_rope=True,
        rope_theta=500000.0,
    ),
    smoke=ModelConfig(
        name="llama3.2-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        mlp_kind="swiglu",
        norm="rms",
        use_rope=True,
        attn_chunk=8,
    ),
    skip_shapes=("long_500k",),
    skip_reasons=(("long_500k", "full quadratic attention"),),
)
