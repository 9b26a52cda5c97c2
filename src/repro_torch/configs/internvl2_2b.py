"""internvl2-2b [vlm] — 24L, d_model=2048, 16H (GQA kv=8), d_ff=8192,
vocab=92553. InternViT vision encoder + projector is a STUB: ``input_specs``
supplies precomputed patch embeddings (256 prefix tokens). [arXiv:2404.16821]
"""

from repro_torch.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        frontend="vision",
        num_frontend_tokens=256,
        rope_theta=1_000_000.0,
        citation="arXiv:2404.16821",
    )
