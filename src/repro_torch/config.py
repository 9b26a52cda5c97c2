"""Configuration dataclasses of the PyTorch port.

A copy of the parts of ``repro.config`` the port needs (``ModelConfig``,
``reduced_config``, ``InputShape``, ``INPUT_SHAPES``, ``MeshConfig`` with the
named meshes and ``mesh_config``, ``TrainConfig``, ``HardwareSpec``): the
port imports nothing of the JAX package, and the machine that runs it has no
JAX at all. ``tests/test_torch_boundaries.py`` holds the copy equal to the
original for every architecture id. ``HardwareSpec`` keeps the reference's
field names but no default values: the reference's defaults describe a TPU,
and the port's one spec (``repro_torch.hw.H100``) fills every field itself.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Hardware characteristics
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float        # bf16 FLOP/s per device
    hbm_bandwidth: float     # bytes/s per device
    ici_bandwidth: float     # bytes/s per device-to-device link
    hbm_bytes: int           # per-device memory capacity
    vmem_bytes: int          # per-block fast-memory budget the fit tests read
    mxu_dim: int             # matrix-unit tile edge


# ---------------------------------------------------------------------------
# Mesh configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. ``data_axes`` are the axes batch is sharded over;
    ``model_axis`` carries tensor/expert parallelism."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"

    @property
    def data_parallelism(self) -> int:
        n = 1
        for s, a in zip(self.shape, self.axis_names):
            if a in ("pod", "data"):
                n *= s
        return n

    @property
    def model_parallelism(self) -> int:
        for s, a in zip(self.shape, self.axis_names):
            if a == "model":
                return s
        return 1


SINGLE_POD_MESH = MeshConfig(shape=(16, 16), axis_names=("data", "model"))
MULTI_POD_MESH = MeshConfig(shape=(2, 16, 16), axis_names=("pod", "data", "model"))
SINGLE_DEVICE_MESH = MeshConfig(shape=(1,), axis_names=("data",))


def mesh_config(multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


# ---------------------------------------------------------------------------
# Input shapes ("data characteristics")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4

    # Hybrid (recurrentgemma): per-block pattern; "r"=RG-LRU, "a"=local attn.
    block_pattern: str = ""        # e.g. "rra" repeated
    window_size: int = 0           # local/sliding attention window (0 = full)
    lru_width: int = 0             # RG-LRU recurrent width (0 = d_model)

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # fixed encoder sequence (1500 audio frames)

    # Modality frontend stub: embeddings supplied by input_specs()
    frontend: str = "none"         # none | audio | vision
    num_frontend_tokens: int = 0   # vision: prefix patch tokens

    # Common
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act_dtype: str = "bfloat16"
    # Sliding-window serving variant for full-attention archs on long
    # contexts. 0 means "arch is natively sub-quadratic or full".
    serve_window: int = 8_192

    citation: str = ""

    # ----- derived -------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can serve very long contexts natively (SSM / hybrid local-attn)."""
        return self.family in ("ssm", "hybrid")

    def layer_pattern(self) -> str:
        """Per-layer block kinds: 'a' attention, 'r' RG-LRU, 's' SSD."""
        if self.family == "ssm":
            return "s" * self.num_layers
        if self.block_pattern:
            pat = (self.block_pattern * (self.num_layers // len(self.block_pattern) + 1))
            return pat[: self.num_layers]
        return "a" * self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n = 0
        # embeddings (+ untied head)
        n += v * d
        if not self.tie_embeddings:
            n += v * d
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d  # q,k,v,o
        # SwiGLU (gate,up,down) everywhere except whisper's 2-matrix GELU MLP
        dense_ffn = (2 if self.family == "audio" else 3) * d * f
        per_layer = {
            "a": attn + dense_ffn,
            "s": self._ssd_layer_params(),
            "r": self._rglru_layer_params(),
        }
        for kind in self.layer_pattern():
            blk = per_layer[kind]
            if kind == "a" and self.num_experts:
                blk = attn + self.num_experts * dense_ffn + d * self.num_experts
            n += blk + 2 * d  # two norms
        if self.is_encdec:
            enc_layer = attn + dense_ffn + 2 * d
            cross = attn + d
            n += self.encoder_layers * enc_layer + self.num_layers * cross
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_ffn = 3 * d * f
        inactive = (self.num_experts - self.experts_per_token) * dense_ffn
        return self.param_count() - self.num_layers * inactive

    def _ssd_layer_params(self) -> int:
        d, di = self.d_model, self.d_inner
        nh, st = self.ssm_num_heads, self.ssm_state
        # in_proj (z,x,B,C,dt), conv, A, D, norm, out_proj
        conv_dim = di + 2 * st
        return (
            d * (2 * di + 2 * st + nh)
            + self.ssm_conv_width * conv_dim
            + 2 * nh
            + di
            + di * d
        )

    def _rglru_layer_params(self) -> int:
        d = self.d_model
        w = self.lru_width or d
        # gates + in/out proj + conv, following RG-LRU (Griffin) block shape
        return 2 * d * w + 2 * w * w + w * d + 4 * w

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family / block structure, tiny dims."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        serve_window=64,
    )
    if cfg.num_experts:
        # dropless capacity (cap >= tokens/group): smoke correctness tests
        # must not depend on which tokens a full forward capacity-drops
        kw.update(num_experts=4, experts_per_token=2, moe_capacity_factor=2.0)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        kw.update(window_size=32, lru_width=128)
    if cfg.is_encdec:
        kw.update(encoder_layers=2, encoder_seq=64)
    if cfg.frontend == "vision":
        kw.update(num_frontend_tokens=16)
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# Training / serving run configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"          # one of repro_torch.nn.optim's optimizers
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    microbatch: Optional[int] = None  # per-step microbatch (grad accumulation)
    remat: bool = True
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    # planner knobs (None = let the compiler decide, SystemML-style)
    force_strategy: Optional[str] = None
    opt_state_dtype: Optional[str] = None  # "float32" | "bfloat16" | None=auto
