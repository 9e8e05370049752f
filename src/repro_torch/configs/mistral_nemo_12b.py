"""mistral-nemo-12b — dense 128k-context [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072.  head_dim=128,
rope_theta=1e6 for the long context.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="mistral-nemo-12b",
    model=ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=131072,
        mlp_kind="swiglu",
        norm="rms",
        use_rope=True,
        rope_theta=1e6,
    ),
    smoke=ModelConfig(
        name="mistral-nemo-12b-smoke",
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
    skip_reasons=(
        (
            "long_500k",
            "full quadratic attention; 128k-trained but O(S^2) — see DESIGN.md "
            "§Arch-applicability",
        ),
    ),
)
