"""internvl2-26b — VLM backbone (InternViT-6B + InternLM2-20B) [arXiv:2404.16821].

Assigned backbone: 48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553.
The vision frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed (B, 256, 6144) patch embeddings prepended to the token stream.
InternLM2 is llama-style: RMSNorm, RoPE, SwiGLU, GQA.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="internvl2-26b",
    model=ModelConfig(
        name="internvl2-26b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=92553,
        mlp_kind="swiglu",
        norm="rms",
        use_rope=True,
        frontend="vision",
        n_patches=256,
    ),
    smoke=ModelConfig(
        name="internvl2-26b-smoke",
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
        frontend="vision",
        n_patches=4,
        attn_chunk=8,
    ),
    skip_shapes=("long_500k",),
    skip_reasons=(
        ("long_500k", "full quadratic attention"),
    ),
)
