"""Model assembly for the dense and SSM families (port of
``repro/models/model.py``).

Parameters are a flat dict with the reference's keys and layer-stacked
layouts (``l.wq`` is ``(L, d, Hq, Dh)``), so weights convert one to one
(``repro_torch.interop``). The reference's ``lax.scan`` over layers becomes
a Python loop over the stacked dimension. Other families raise
``NotImplementedError`` naming the slice that ports them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.common import SpecBuilder, rms_norm

# family -> the port slice that brings it (ROADMAP.md "Queue A")
_LATER_SLICES = {"hybrid": 3, "moe": 6, "vlm": 6, "audio": 6}
_PORTED = ("dense", "ssm")


def _subtree(params: Dict, prefix: str) -> Dict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in params.items() if k.startswith(prefix)}


class Model:
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
        if cfg.family not in _PORTED or cfg.num_experts or cfg.is_encdec:
            slice_no = _LATER_SLICES.get(cfg.family, 6)
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is ported in slice "
                f"{slice_no} of the PyTorch port; the port serves the "
                f"{' and '.join(_PORTED)} families so far")
        self.cfg = cfg
        self.dtype = dtype
        self.sb = self._build_specs()

    # ------------------------------------------------------------------
    # parameter specs
    # ------------------------------------------------------------------
    def _build_specs(self) -> SpecBuilder:
        cfg = self.cfg
        sb = SpecBuilder(self.dtype)
        sb.add("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
               "normal", scale=0.02)
        blocks = B.ssd_block_params(cfg) if self.is_ssm else B.attn_block_params(cfg)
        for name, (shape, axes, init) in blocks.items():
            sb.add(f"l.{name}", (cfg.num_layers, *shape), ("layers", *axes), init)
        sb.add("final_ln", (cfg.d_model,), (None,), "ones")
        if not cfg.tie_embeddings:
            sb.add("head", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                   "normal", scale=0.02)
        return sb

    @property
    def is_ssm(self) -> bool:
        return self.cfg.family == "ssm"

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.sb.init(generator)

    def param_count(self) -> int:
        return sum(math.prod(sh) for sh, _dt in self.sb.shapes().values())

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens.long()]
        if self.cfg.tie_embeddings:
            x = x * (self.cfg.d_model ** 0.5)
        return x

    def _logits(self, params, x):
        if self.cfg.tie_embeddings:
            return torch.matmul(x, params["embed"].t())
        return torch.matmul(x, params["head"])

    @staticmethod
    def _layer(stacked: Dict, i: int) -> Dict:
        return {k: v[i] for k, v in stacked.items()}

    # ------------------------------------------------------------------
    # full-sequence forward (prefill)
    # ------------------------------------------------------------------
    def apply(self, params, tokens: torch.Tensor, *,
              last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(logits, aux_loss)``: logits for every position, or
        with ``last_only`` for the final position only (``(B, 1, vocab)``).
        Neither ported family has an auxiliary loss (0)."""
        x, _ = self._stack_prefill(params, self._embed(params, tokens),
                                   want_cache=False)
        x = rms_norm(x, params["final_ln"])
        logits = self._logits(params, x[:, -1:] if last_only else x)
        return logits, torch.zeros((), device=logits.device)

    def _stack_prefill(self, params, x, *, lengths: Optional[torch.Tensor] = None,
                       want_cache: bool = True):
        """The layer stack over a full sequence. With ``want_cache`` also
        the layer-stacked per-layer caches: rope'd K/V ``(L, B, S, Kv, Dh)``
        for attention, the decode state after each row's ``lengths`` prompt
        tokens for SSD."""
        cfg = self.cfg
        stacked = _subtree(params, "l.")
        positions = torch.arange(x.shape[1], device=x.device)
        caches = []
        for i in range(cfg.num_layers):
            lp = self._layer(stacked, i)
            if self.is_ssm:
                out = B.ssd_block_apply(cfg, lp, x, lengths=lengths,
                                        want_cache=want_cache)
                x, c = out if want_cache else (out, None)
            else:
                x, c = B.attn_block_apply(cfg, lp, x, positions, causal=True,
                                          window=cfg.window_size)
            if want_cache:
                caches.append(c)
        if not want_cache:
            return x, None
        return x, {f"l.{k}": torch.stack([c[k] for c in caches]) for k in caches[0]}

    def prefill(self, params, tokens: torch.Tensor, *,
                lengths: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None):
        """Prompt pass returning ``(last_logits, cache)``: each row's
        next-token logits at its own final prompt position ``(B, vocab)``
        and a populated decode cache — the :meth:`init_cache` dict at
        ``(batch, cache_len)`` — for the prefill→decode handoff.
        ``lengths`` is the per-row prompt length inside the padded
        ``tokens`` (default: the full width)."""
        b, s = tokens.shape
        dev = tokens.device
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        lengths = lengths.to(device=dev, dtype=torch.int32)
        cache_len = int(cache_len) if cache_len else s
        x, cache = self._stack_prefill(params, self._embed(params, tokens),
                                       lengths=lengths)
        x = rms_norm(x, params["final_ln"])
        # the reference's take_along_axis clamps; lengths >= 1 on every path
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
        xl = x[torch.arange(b, device=dev), last]                  # (B, D)
        logits = self._logits(params, xl[:, None])[:, 0]
        # attention K/V land in their decode-slot layout; recurrent state
        # entries are already in decode form
        sc = self.attn_cache_len(cache_len)
        cache = {k: (gather_cache_slots(v, lengths, sc) if self.is_paged_cache_key(k)
                     else v) for k, v in cache.items()}
        return logits, cache

    # ------------------------------------------------------------------
    # serving: cache construction + one-token decode
    # ------------------------------------------------------------------
    def attn_cache_len(self, seq_len: int) -> int:
        """Attention cache slots for a ``seq_len`` context: the window for
        sliding-window archs, min(seq, serve_window) beyond the long-context
        threshold, the full context otherwise."""
        cfg = self.cfg
        if cfg.window_size:
            return min(seq_len, cfg.window_size)
        if seq_len > 262_144 and cfg.serve_window:
            return min(seq_len, cfg.serve_window)
        return seq_len

    def decode_window(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.window_size:
            return cfg.window_size
        if seq_len > 262_144 and cfg.serve_window:
            return cfg.serve_window
        return 0

    def cache_entries(self, batch: int, seq_len: int) -> Dict[str, Tuple]:
        """{name: (shape, axes, dtype)} for the decode cache."""
        cfg = self.cfg
        ent = {}
        if self.is_ssm:
            for name, (shape, axes, dt) in B.ssd_cache_spec(cfg, batch, self.dtype).items():
                ent[f"l.{name}"] = ((cfg.num_layers, *shape), ("layers", *axes), dt)
            return ent
        sc = self.attn_cache_len(seq_len)
        for name, (shape, axes) in B.attn_cache_spec(cfg, batch, sc).items():
            ent[f"l.{name}"] = ((cfg.num_layers, *shape), ("layers", *axes),
                                self.dtype)
        return ent

    @staticmethod
    def is_paged_cache_key(key: str) -> bool:
        """Attention K/V stacks page their sequence dimension; recurrent
        state is O(1) in sequence and stays per row."""
        return (key.endswith(".k") or key.endswith(".v")) and not key.startswith("x.")

    def paged_cache_entries(self, batch: int, seq_len: int, page: int):
        """Block-granular layout: attention K/V trade their per-row sequence
        dimension ``(L, B, sc, Kv, Dh)`` for one flat per-arena slot stack
        ``(L, n_pages * page, Kv, Dh)`` shared by all rows through per-row
        page tables; everything else keeps its ``(L, B, ...)`` row layout.
        Returns ``(entries, n_pages, sc)``; ``n_pages`` is 0 when no entry
        pages (the SSM family)."""
        ent = self.cache_entries(batch, seq_len)
        sc = self.attn_cache_len(seq_len)
        has_paged = any(self.is_paged_cache_key(k) for k in ent)
        n_pages = batch * -(-sc // page) if has_paged else 0
        out = {}
        for k, (shape, axes, dt) in ent.items():
            if self.is_paged_cache_key(k):
                ll, _b, _s, *rest = shape
                out[k] = ((ll, n_pages * page, *rest),
                          (axes[0], "kv_slots", *axes[3:]), dt)
            else:
                out[k] = (shape, axes, dt)
        return out, n_pages, sc

    def init_cache(self, batch: int, seq_len: int, device) -> Dict[str, torch.Tensor]:
        ent = self.cache_entries(batch, seq_len)
        return {k: torch.zeros(s, dtype=d, device=device) for k, (s, _a, d) in ent.items()}

    def init_paged_cache(self, batch: int, seq_len: int, page: int, device):
        ent, _n_pages, _sc = self.paged_cache_entries(batch, seq_len, page)
        return {k: torch.zeros(s, dtype=d, device=device) for k, (s, _a, d) in ent.items()}

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    pos: torch.Tensor, *, window_override: Optional[int] = None,
                    tables: Optional[torch.Tensor] = None, page: int = 0,
                    seq_len: int = 0, decode_kernel: str = "gather"):
        """tokens: (B, 1); pos: scalar or (B,) int32 — rows may sit at
        different generation depths. Returns ``(logits, cache)``; the cache
        tensors are updated in place and returned for the caller's
        convenience. With ``tables``/``page`` the attention K/V in ``cache``
        are flat slot stacks (``paged_cache_entries``) read through the
        (B, max_pages) int32 page table, ``seq_len`` is the bucket context
        the arena was sized for, and ``decode_kernel`` picks the paged read
        (paged | gather | ref; see ``blocks.attn_block_decode``). The SSM
        family ignores ``pos``, ``tables`` and the window: its state is
        per row."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        stacked = _subtree(params, "l.")
        if self.is_ssm:
            names = [k[2:] for k in cache if k.startswith("l.")]
            for i in range(cfg.num_layers):
                x = B.ssd_block_decode(cfg, self._layer(stacked, i), x,
                                       {n: cache[f"l.{n}"][i] for n in names})
            x = rms_norm(x, params["final_ln"])
            return self._logits(params, x), cache
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        paged = tables is not None and page > 0
        sc = self.attn_cache_len(seq_len) if paged else 0
        window = (window_override if window_override is not None
                  else self.decode_window(seq_len if paged else cache["l.k"].shape[2]))
        if not paged:
            tables, page = None, 0
        ck, cv = cache["l.k"], cache["l.v"]
        for i in range(cfg.num_layers):
            x = B.attn_block_decode(cfg, self._layer(stacked, i), x,
                                    {"k": ck[i], "v": cv[i]}, pos, window=window,
                                    tables=tables, page=page, sc=sc,
                                    decode_kernel=decode_kernel)
        x = rms_norm(x, params["final_ln"])
        return self._logits(params, x), cache


def gather_cache_slots(kv: torch.Tensor, lengths: torch.Tensor,
                       sc: int) -> torch.Tensor:
    """Map full-sequence K/V ``(L, B, S, Kv, Dh)`` onto decode-cache slots
    ``(L, B, sc, Kv, Dh)``: slot ``i`` of row ``r`` holds the latest prompt
    position ``p ≡ i (mod sc)`` with ``p < lengths[r]`` (the rotating-window
    layout; the identity when ``sc >= S``). Slots with no valid position are
    zeroed."""
    b, s = kv.shape[1], kv.shape[2]
    last = lengths.long()[:, None] - 1                                # (B, 1)
    i = torch.arange(sc, device=kv.device)[None, :]
    p = last - torch.remainder(last - i, sc)                          # (B, sc)
    valid = (p >= 0)[None, :, :, None, None]
    pc = torch.clamp(p, 0, s - 1)
    out = kv[:, torch.arange(b, device=kv.device)[:, None], pc]       # (L, B, sc, ...)
    return torch.where(valid, out, torch.zeros((), dtype=kv.dtype, device=kv.device))


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16) -> Model:
    return Model(cfg, dtype)
