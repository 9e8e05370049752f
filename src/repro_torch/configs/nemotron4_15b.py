"""nemotron-4-15b — dense, squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000.  Nemotron-4 uses
squared-ReLU (non-gated) MLPs, RoPE, LayerNorm.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="nemotron-4-15b",
    model=ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=256000,
        mlp_kind="relu2",
        norm="ln",
        use_rope=True,
    ),
    smoke=ModelConfig(
        name="nemotron-4-15b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab=512,
        mlp_kind="relu2",
        norm="ln",
        use_rope=True,
        attn_chunk=8,
    ),
    skip_shapes=("long_500k",),
    skip_reasons=(
        ("long_500k", "full quadratic attention"),
    ),
)
