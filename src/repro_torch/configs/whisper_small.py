"""whisper-small — enc-dec audio backbone [arXiv:2212.04356].

12L (enc+dec) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  The conv/mel
frontend is a STUB per the assignment: ``input_specs`` supplies precomputed
(B, 1500, 768) frame embeddings.  Whisper is pre-RoPE: learned absolute
positions, LayerNorm, GELU MLP, qkv bias.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="whisper-small",
    model=ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab=51865,
        mlp_kind="gelu",
        norm="ln",
        use_rope=False,
        qkv_bias=True,
        enc_seq=1500,
        frontend="audio",
        # Whisper's real decoder max is 448; the assigned synthetic 32k
        # prefill/decode cells need a position table covering seq_len.
        max_dec_seq=32_768,
    ),
    smoke=ModelConfig(
        name="whisper-small-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        mlp_kind="gelu",
        norm="ln",
        use_rope=False,
        qkv_bias=True,
        enc_seq=16,
        frontend="audio",
        attn_chunk=8,
        max_dec_seq=64,
    ),
    skip_shapes=("long_500k",),
    skip_reasons=(
        ("long_500k", "full quadratic attention (enc-dec); no sub-quadratic path"),
    ),
)
