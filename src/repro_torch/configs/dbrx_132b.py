"""dbrx-132b — fine-grained MoE [hf:databricks/dbrx-base].

40L d_model=6144 48H (kv=8) d_ff=10752 vocab=100352, MoE 16 experts top-4.
GLU MLP experts, RoPE, GQA.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="dbrx-132b",
    model=ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        n_experts=16,
        top_k=4,
        mlp_kind="swiglu",
        norm="ln",
        use_rope=True,
    ),
    smoke=ModelConfig(
        name="dbrx-132b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
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
