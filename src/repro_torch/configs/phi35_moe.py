"""phi3.5-moe-42b-a6.6b — MoE [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="phi3.5-moe-42b-a6.6b",
    model=ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab=32064,
        n_experts=16,
        top_k=2,
        mlp_kind="swiglu",
        norm="ln",
        use_rope=True,
    ),
    smoke=ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab=512,
        n_experts=4,
        top_k=2,
        mlp_kind="swiglu",
        norm="ln",
        use_rope=True,
        attn_chunk=8,
    ),
    skip_shapes=("long_500k",),
    skip_reasons=(
        ("long_500k", "full quadratic attention"),
    ),
)
