"""mamba2-1.3b [ssm] — 48L, d_model=2048, attention-free SSD
(state-space duality), ssm_state=128, vocab=50280. [arXiv:2405.21060]
"""

from repro_torch.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv_width=4,
        tie_embeddings=True,
        citation="arXiv:2405.21060",
    )
