"""whisper-medium [audio] — encoder-decoder transformer backbone.

24 decoder layers, d_model=1024, 16 heads (GQA kv=16 i.e. MHA), d_ff=4096,
vocab=51865. Conv/mel frontend is a STUB: ``input_specs`` supplies
precomputed 1500-frame encoder embeddings. [arXiv:2212.04356]
"""

from repro_torch.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        encoder_layers=24,
        encoder_seq=1500,
        frontend="audio",
        tie_embeddings=True,
        citation="arXiv:2212.04356",
    )
