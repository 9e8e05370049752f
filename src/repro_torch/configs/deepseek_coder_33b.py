"""deepseek-coder-33b — dense llama-arch [arXiv:2401.14196].

62L d_model=7168 56H (kv=8) d_ff=19200 vocab=32256.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="deepseek-coder-33b",
    model=ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab=32256,
        mlp_kind="swiglu",
        norm="rms",
        use_rope=True,
    ),
    smoke=ModelConfig(
        name="deepseek-coder-33b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab=512,
        mlp_kind="swiglu",
        norm="rms",
        use_rope=True,
        attn_chunk=8,
    ),
    skip_shapes=("long_500k",),
    skip_reasons=(
        ("long_500k", "full quadratic attention"),
    ),
)
