"""recurrentgemma-2b [hybrid] — 26L, d_model=2560, 10H (GQA kv=1 / MQA),
d_ff=7680, vocab=256000. RG-LRU + local attention, pattern 1 attn : 2 LRU.
[arXiv:2402.19427]
"""

from repro_torch.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        block_pattern="rra",       # 2 recurrent : 1 local-attention
        window_size=2048,
        lru_width=2560,
        tie_embeddings=True,
        citation="arXiv:2402.19427",
    )
