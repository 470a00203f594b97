"""The paged decode kernel's logit softcap (gemma2's attention) held
against the JAX package: the port's ``paged_attention(...,
logit_softcap=...)`` (its plain version here, as on every CPU tensor)
against the TPU kernel ``paged_attention_pallas(..., logit_softcap=...,
interpret=True)`` on the same numpy-seeded inputs, at gemma2-9b's head
layout (8 KV heads, group 2) with a narrow head dim, with and without a
sliding window; and a reduced gemma2-9b engine whose decode takes the
kernel's route with streams equal to the JAX engine's.

Tolerances. Float: rtol = atol = 1e-5 in float32 (the port sums by
pairwise halving, XLA in its own order; the two ``tanh`` and ``exp``
differ in the last ulps). SC: the PV counts, recovered from the outputs
as ``out / (N * dp * dv)`` with every value row's scale ``dv`` a power of
two (so each implementation's float sums of ``count * dv`` are exact),
must be equal; a row where a probability sits within 1e-3 of a rounding
boundary of its quantizer (the two ``tanh``/``exp`` lowerings may move it
across) is held to one quantization step of output instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.kernels.paged_attention import paged_attention_pallas
from repro.models import bind as jbind
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.serving import Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

CAP = 50.0
#: gemma2-9b's decode layout (8 KV heads, 16 query heads) at head dim 16
C, KV, G, D, BLOCK, MB = 3, 8, 2, 16, 4, 5
POSITIONS = [17, 9, 3]


def _inputs(seed: int, bits: int | None = None):
    """Fragmented page tables and random q, k, v (float32). With ``bits``,
    every value row's largest magnitude is ``n_max / 2**e`` so its SC
    scale ``dv`` is a power of two."""
    rng = np.random.default_rng(seed)
    n_pages = C * MB + 1
    perm = rng.permutation(n_pages - 1)
    tables = np.full((C, MB), -1, np.int32)
    used = 0
    for i, p in enumerate(POSITIONS):
        need = p // BLOCK + 1
        tables[i, :need] = perm[used:used + need]
        used += need
    # large enough that scores reach the cap's bend (|s| up to ~2 cap)
    q = 12 * rng.standard_normal((C, KV, G, D)).astype(np.float32)
    k = 12 * rng.standard_normal((n_pages, BLOCK, KV, D)).astype(np.float32)
    v = rng.uniform(-1, 1, (n_pages, BLOCK, KV, D)).astype(np.float32)
    if bits is not None:
        top = _dv(bits) * (2 ** bits - 1)
        v = v * np.float32(0.99 * top)
        v[..., 0] = np.where(rng.random(v.shape[:-1]) < 0.5, -top, top)
    return q, k, v, tables, np.asarray(POSITIONS, np.int32)


def _dv(bits: int) -> float:
    """The value rows' SC scale: a power of two."""
    return 2.0 ** -(bits - 2)


def _both(inputs, window, bits):
    got = paged_attention(*(torch.as_tensor(x) for x in inputs),
                          window=window, logit_softcap=CAP, sc_bits=bits)
    want = paged_attention_pallas(*(jnp.asarray(x) for x in inputs),
                                  window=window, logit_softcap=CAP, kvh=2,
                                  interpret=True, sc_bits=bits)
    return got.numpy(), np.asarray(want)


def _probabilities(q, k, tables, pos, window, bits):
    """The normalized probabilities (C, KV, G, S) the SC path quantizes:
    the SC scores (exact counts times their scales, float32), then the
    cap, the masks and the softmax in float64."""
    from repro_torch.kernels.sc_attention import sc_scores
    pages = np.where(tables < 0, k.shape[0] - 1, tables)
    rows = k[pages].reshape(C, MB * BLOCK, KV, D).transpose(0, 2, 1, 3)
    s = sc_scores(torch.as_tensor(q), torch.as_tensor(np.ascontiguousarray(
        rows)), bits=bits) * D ** -0.5                      # (C, KV, G, S)
    s = CAP * np.tanh(s.double().numpy() / CAP)
    kpos = np.arange(MB * BLOCK)[None, :]
    mask = kpos <= pos[:, None]
    if window is not None:
        mask &= pos[:, None] - kpos < window
    s = np.where(mask[:, None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("window", [None, 6], ids=["global", "window6"])
def test_paged_softcap_float_equals_jax_kernel(window):
    inputs = _inputs(7 + (window or 0))
    got, want = _both(inputs, window, None)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the cap acts: without it the same call differs beyond the tolerance
    plain = paged_attention(*(torch.as_tensor(x) for x in inputs),
                            window=window).numpy()
    assert np.abs(plain - got).max() > 1e-3


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("window", [None, 6], ids=["global", "window6"])
def test_paged_softcap_sc_counts_equal_jax_kernel(window, bits):
    q, k, v, tables, pos = inputs = _inputs(11 + bits + (window or 0), bits)
    got, want = _both(inputs, window, bits)
    p = _probabilities(q, k, tables, pos, window, bits)
    n_max = 2 ** bits - 1
    dp = p.max(-1) / n_max                                 # (C, KV, G)
    unit = (2 ** bits * dp * _dv(bits))[..., None]
    counts_got = np.rint(got / unit).astype(np.int64)
    counts_want = np.rint(want / unit).astype(np.int64)
    # each output is an integer count times its unit, up to rounding
    for out, counts in ((got, counts_got), (want, counts_want)):
        np.testing.assert_allclose(out, counts * unit, rtol=1e-5, atol=0)
    x = p / dp[..., None]
    near = np.abs(x - np.floor(x) - 0.5) < 1e-3             # (C, KV, G, S)
    edge = near.any(-1)                                     # (C, KV, G)
    np.testing.assert_array_equal(counts_got[~edge], counts_want[~edge])
    step = np.abs(v).max() / n_max
    assert np.abs(got - want)[edge].max(initial=0.0) <= step
    assert edge.mean() < 0.5, edge.mean()


def test_gemma2_engine_decodes_through_the_paged_kernel_route(monkeypatch):
    """Reduced gemma2-9b (softcap 50 on every layer, window 8 on every
    other): each decode step reaches the paged kernel's wrapper once a
    layer with the cap (on the CPU the wrapper runs its plain version;
    ``paged_attention.launches`` counts launches on the card, so the
    wrapper's calls are counted here), and the streams equal the JAX
    engine's."""
    import repro_torch.kernels.paged_attention as pa
    arch = "gemma2-9b"
    jcfg = JAX_ARCHS[arch].reduced(dtype="float32")
    tcfg = ARCHS[arch].reduced(dtype="float32")
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (12, 7)]
    gens = [6, 4]
    kw = dict(capacity=2, max_seq=20, block=4, chunk=16)
    want = JaxEngine(jcfg, jp, prefix_cache=False, **kw).run(
        [JaxRequest(uid=f"r{i}", prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(zip(prompts, gens))])
    calls, wrapped = [], pa.paged_attention

    def spy(*args, **kwargs):
        calls.append(kwargs.get("logit_softcap"))
        return wrapped(*args, **kwargs)
    monkeypatch.setattr(pa, "paged_attention", spy)
    eng = Engine(tcfg, tp, device="cpu", prefix_cache=False, **kw)
    got = eng.run([Request(uid=f"r{i}", prompt=p, max_new_tokens=g)
                   for i, (p, g) in enumerate(zip(prompts, gens))])
    for r, j in zip(got, want):
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
    steps = eng.stats["decode_steps"]
    assert steps > 0 and calls == [CAP] * (steps * tcfg.n_layers)
    assert max(len(p) + g for p, g in zip(prompts, gens)) > tcfg.windows[0]
