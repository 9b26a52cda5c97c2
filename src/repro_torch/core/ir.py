"""Light logical operator graph (a copy of ``repro/core/ir.py``; pure Python
over ``ModelConfig``).

SystemML compiles DML into a DAG of high-level operators (HOPs) with
per-operator output-size and memory estimates, then selects physical
operators (LOPs). We keep a miniature version: enough structure for the
memory/cost estimators and the benchmark tables to reason per-operator,
without re-implementing a full HOP/LOP stack (PyTorch owns that level).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.config import InputShape, ModelConfig


@dataclass(frozen=True)
class LogicalOp:
    name: str
    kind: str                  # matmul | attention | scan | norm | router | ...
    flops: float
    bytes_in: float
    bytes_out: float
    count: int = 1             # how many times per step (e.g. per layer)

    @property
    def total_flops(self) -> float:
        return self.flops * self.count

    @property
    def arithmetic_intensity(self) -> float:
        b = self.bytes_in + self.bytes_out
        return self.flops / b if b else float("inf")


@dataclass
class OpGraph:
    ops: List[LogicalOp] = field(default_factory=list)

    def add(self, op: LogicalOp) -> None:
        self.ops.append(op)

    @property
    def total_flops(self) -> float:
        return sum(o.total_flops for o in self.ops)

    @property
    def total_bytes(self) -> float:
        return sum((o.bytes_in + o.bytes_out) * o.count for o in self.ops)

    def dominant(self, n: int = 5) -> List[LogicalOp]:
        return sorted(self.ops, key=lambda o: -o.total_flops)[:n]

    def table(self) -> str:
        rows = ["op,kind,count,gflops,intensity"]
        for o in sorted(self.ops, key=lambda o: -o.total_flops):
            rows.append(
                f"{o.name},{o.kind},{o.count},{o.total_flops / 1e9:.2f},"
                f"{o.arithmetic_intensity:.1f}"
            )
        return "\n".join(rows)


def build_op_graph(model: ModelConfig, shape: InputShape) -> OpGraph:
    """Analytic per-operator graph for one forward pass."""
    g = OpGraph()
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    tok = b * s
    d = model.d_model
    A = 2  # bytes (bf16)

    def mm(name, m, k, n, count=1, kind="matmul"):
        g.add(LogicalOp(name, kind, 2.0 * m * k * n,
                        (m * k + k * n) * A, m * n * A, count))

    pat = model.layer_pattern()
    n_attn = pat.count("a")
    n_ssd = pat.count("s")
    n_lru = pat.count("r")

    if n_attn:
        h, kv, hd, f = model.num_heads, model.num_kv_heads, model.head_dim, model.d_ff
        mm("q_proj", tok, d, h * hd, n_attn)
        mm("kv_proj", tok, d, 2 * kv * hd, n_attn)
        ctx = shape.seq_len if shape.kind == "decode" else s
        if model.window_size:
            ctx = min(ctx, model.window_size)
        g.add(LogicalOp("attention", "attention",
                        4.0 * b * s * ctx * h * hd / (1 if shape.kind == "decode" else 2),
                        tok * (h + 2 * kv) * hd * A, tok * h * hd * A, n_attn))
        mm("o_proj", tok, h * hd, d, n_attn)
        if model.num_experts:
            g.add(LogicalOp("router", "router", 2.0 * tok * d * model.num_experts,
                            tok * d * A, tok * model.num_experts * A, n_attn))
            mm("expert_ffn", tok * model.experts_per_token, d, 3 * f, n_attn, "moe")
        else:
            mm("ffn", tok, d, 3 * f, n_attn)
    if n_ssd:
        di, st, nh = model.d_inner, model.ssm_state, model.ssm_num_heads
        mm("ssd_in_proj", tok, d, 2 * di + 2 * st + nh, n_ssd)
        g.add(LogicalOp("ssd_scan", "scan", 6.0 * tok * di * st,
                        tok * (di + 2 * st) * A, tok * di * A, n_ssd))
        mm("ssd_out_proj", tok, di, d, n_ssd)
    if n_lru:
        w = model.lru_width or d
        mm("lru_proj", tok, d, 2 * w, n_lru)
        g.add(LogicalOp("rg_lru", "scan", 8.0 * tok * w,
                        tok * w * A, tok * w * A, n_lru))
        mm("lru_out", tok, w, d, n_lru)
    g.add(LogicalOp("norms", "norm", 6.0 * tok * d,
                    tok * d * A, tok * d * A, len(pat)))
    mm("lm_head", tok if shape.kind != "decode" else b, d, model.vocab_size)
    return g
