"""The reference's one-device serving and the checks that hold the port's
serving under a model axis to it (``tests/test_torch_serve_tp*.py``).

A prompt pass over padded prompts of mixed lengths in a bucket, then
greedy decode ticks from the handed-off cache, both through the
reference's ``Model.prefill`` / ``Model.decode_step`` in float32 on one
device; a family without a handoff takes the last position's logits of
``apply`` and decodes from a zero cache at positions from 0 (an
encoder-decoder's cross K/V from ``build_cross_cache``). The port runs the
same weights on gloo CPU ranks (``_torch_ranks.tp_serve_case``). Its
streams must be byte-identical to the reference's and its logits within
the one-device serving tests' float32 tolerance
(``tests/test_torch_model.py``: ``rtol = atol = 1e-4``; the model axis
sums partial products in another order again).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models.model import build_model as jax_build

from _torch_ranks import run_ranks

BATCH, BUCKET, N_NEW = 4, 32, 6
LOGIT_TOL = 1e-4
# the planner's DP_TP serve layouts (repro/core/planner.py::_serve_candidates)
HEADS = (("cache_heads_over_model", True),)
SEQ = (("cache_seq_axes", ("model",)),)
CP = (("seq_axes", ("model",)),)
MOE = (("expert_parallel", True),)

_REF = {}


def prompts(vocab, seed=3):
    """Mixed-length prompts padded into the bucket, and their lengths."""
    rng = np.random.default_rng(seed)
    lengths = np.array([BUCKET - N_NEW - 2, 9, BUCKET - N_NEW - 11, 17], np.int32)[:BATCH]
    tokens = rng.integers(1, vocab, size=(BATCH, BUCKET), dtype=np.int32)
    return tokens, lengths


def reference(arch, cut=(), gain=None, extra_seed=None):
    """The reference's init (numpy), inputs and one-device serving of them:
    ``(init, tokens, lengths, extra, first logits, per-tick logits,
    stream)``."""
    key = (arch, tuple(cut), gain, extra_seed)
    if key in _REF:
        return _REF[key]
    jcfg = jax_config(arch).replace(**dict(cut))
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    if gain is not None:
        jp = {k: v * gain if k.endswith((".ln1", ".xln")) else v for k, v in jp.items()}
    init = {k: np.asarray(v) for k, v in jp.items()}
    tokens, lengths = prompts(jcfg.vocab_size)
    extra = {}
    rng = np.random.default_rng(11)
    if jcfg.frontend == "vision":
        extra["patch_embeds"] = rng.standard_normal(
            (BATCH, jcfg.num_frontend_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.is_encdec:
        extra["frames"] = rng.standard_normal(
            (BATCH, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    jex = {k: jnp.asarray(v) for k, v in extra.items()}
    handoff = not jcfg.is_encdec and jcfg.frontend == "none"
    if handoff:
        first, cache = jm.prefill(jp, jnp.asarray(tokens), jex, lengths=jnp.asarray(lengths),
                                  cache_len=BUCKET)
        pos = jnp.asarray(lengths)
    else:
        first = jm.apply(jp, jnp.asarray(tokens), jex, last_only=True)[0][:, -1]
        cache = jm.init_cache(BATCH, BUCKET)
        if jcfg.is_encdec:
            cache.update(jm.build_cross_cache(jp, jex["frames"]))
        pos = jnp.zeros((BATCH,), jnp.int32)
    step = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q))
    tok = jnp.argmax(first, axis=-1).astype(jnp.int32)[:, None]
    stream, logits = [np.asarray(tok)], []
    for _ in range(N_NEW):
        lg, cache = step(jp, cache, tok, pos)
        logits.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        stream.append(np.asarray(tok))
        pos = pos + 1
    _REF[key] = (init, tokens, lengths, extra, np.asarray(first), logits,
                 np.concatenate(stream, axis=1))
    return _REF[key]


def serve_rank_runs(runs):
    """A module fixture: each run of ``runs`` ({name: (arch, cut, gain,
    mesh, cases)}) on gloo CPU ranks, its cases in one process group."""

    @pytest.fixture(scope="module")
    def rank_runs(tmp_path_factory):
        out = {}
        for name, (arch, cut, gain, mesh, cases) in runs.items():
            init, tokens, lengths, extra, *_ = reference(arch, cut, gain)
            out[name] = run_ranks("tp_serve_case", mesh[0] * mesh[1],
                                  tmp_path_factory.mktemp("s"), arch, init, cases, mesh, cut,
                                  tokens, lengths, BUCKET, N_NEW, extra)
        return out

    return rank_runs


def serve_params(runs):
    """``(run, case name)`` pairs of ``runs`` and their ids."""
    params = [(run, case[0]) for run, (*_r, cases) in runs.items() for case in cases]
    return params, [f"{r}-{c}" for r, c in params]


def check_serve_run(runs, rank_runs, run, name):
    """Every rank's rows (its data block of the batch) serve exactly the
    reference's stream, and their logits are the reference's within
    ``LOGIT_TOL``; every model rank of a data group holds the same
    results. Returns the ranks' outputs of the case."""
    arch, cut, gain, mesh, cases = runs[run]
    _init, _t, _l, _e, first, logits, stream = reference(arch, cut, gain)
    names = [c[0] for c in cases]
    outs = [r[names.index(name)] for r in rank_runs[run]]
    d, m = mesh
    rows = BATCH // d if BATCH % d == 0 else BATCH
    for rank, out in enumerate(outs):
        lo = (rank // m) * rows if rows != BATCH else 0
        np.testing.assert_array_equal(out["stream"], stream[lo:lo + rows],
                                      err_msg=f"rank {rank} {name}")
        np.testing.assert_allclose(out["first"], first[lo:lo + rows], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"rank {rank} {name} prefill")
        for t, (g, w) in enumerate(zip(out["logits"], logits, strict=True)):
            np.testing.assert_allclose(g, w[lo:lo + rows], rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                       err_msg=f"rank {rank} {name} tick {t}")
    return outs
