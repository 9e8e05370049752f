"""recurrentgemma-2b — RG-LRU + local attention hybrid [arXiv:2402.19427].

26L d_model=2560 10H (kv=1) d_ff=7680 vocab=256000; block pattern
(rec, rec, attn) — two RG-LRU blocks per local-attention block (1:2),
window 2048.  Runs long_500k: decode state is O(window + lru_width).
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="recurrentgemma-2b",
    model=ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        pattern=("rec", "rec", "attn"),
        window=2048,
        lru_width=2560,
        mlp_kind="geglu",
        norm="rms",
        use_rope=True,
    ),
    smoke=ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        pattern=("rec", "rec", "attn"),
        window=16,
        lru_width=64,
        mlp_kind="geglu",
        norm="rms",
        use_rope=True,
        attn_chunk=8,
    ),
)
