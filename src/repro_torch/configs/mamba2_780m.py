"""mamba2-780m — SSD state-space model [arXiv:2405.21060].

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2·1536 = 3072, head_dim 64 → 48 SSD heads.  Runs long_500k:
decode is O(1) in sequence length (constant-size SSM state).
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.model import ModelConfig

SPEC = ArchSpec(
    arch_id="mamba2-780m",
    model=ModelConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        vocab=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        norm="rms",
    ),
    smoke=ModelConfig(
        name="mamba2-780m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        vocab=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        norm="rms",
    ),
)
