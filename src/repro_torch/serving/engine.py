"""Continuous-batching serving engine (port of ``repro/serving/engine.py``).

The engine is a step scheduler: one :meth:`Engine.step` spends a bounded
budget of prefill-chunk work, admits a completed prefill into the pool, and
runs one batched decode over every live slot; :meth:`Engine.run` and
:meth:`Engine.stream` are loops over it.

* *Chunked prefill (default)*: a prompt is prefilled ``chunk`` tokens at a
  time into a B=1 staging cache of its prompt-bucket extent
  (``launch.steps.prompt_buckets``); each step spends at most
  ``prefill_budget`` tokens on it, so admission never stalls batched decode
  for more than a chunk. The finished staging cache is truncated to the
  prompt (``cache_ops.truncate_seq``) and admitted like a one-shot prefill.
  ``prefill_mode="oneshot"`` keeps whole-prompt admission as the A/B.
  Either runs through a ``launch.steps.PrefillStep`` of its shape (the
  bucket, or the prompt length): the engine stages a prompt in pinned host
  buffers once, copies each chunk's tokens and valid length into the
  step's static buffers, replays it, and reads the final logit row. On the
  card a step is its shape's captured CUDA graph, captured at first use
  (``launch.steps.cached_chunked_prefill_step`` /
  ``cached_prefill_step``); on the CPU it runs eagerly.
* *Prefix cache (paged + chunked + dense, on by default)*: before staging
  a prompt the engine matches it against a token-hash radix tree
  (``serving.prefix``, DESIGN.md §12) of block-aligned prompt prefixes
  whose pages are resident in the pool. On a hit the matched pages are
  pinned, the bucket step's staging cache is seeded with their K/V and its
  position set to the resume offset (``PrefillStep.seed``), and only the
  suffix's chunks run — the same chunk graph a cold prompt replays at that
  offset. Admission attaches the slot's table to the shared pages and
  copies the page holding the resume point (copy-on-write); every
  admission registers the prompt's full pages in the tree, which keeps
  them warm after their last reference drops.
* *Grow (paged)*: before each decode step every live slot's next write
  position gets its page, copied first if it is shared or retained
  (``PagedSlotPool.ensure_page``); exhaustion
  preempts youngest-first — an in-flight staging prefill included — and
  re-queues the request, whose restarted stream is identical.
* *Decode*: one paged (or dense) decode step advances all slots a token;
  tokens are pushed through per-request ``on_token`` callbacks or pulled
  through :meth:`Engine.stream`. The step is a
  ``launch.steps.DecodeStep`` over static buffers: the engine copies the
  tokens and the block table in from pinned host staging, replays it, and
  reads the logit rows. On the card it is the decode shape's cached step,
  one CUDA graph replay a decode step (``launch.steps.cached_decode_step``,
  looked up at construction); on the CPU it runs eagerly.
* *Speculate* (``speculate_k = k > 0``): each decode step is a
  self-speculative round instead. A draft step proposes ``k`` tokens a
  slot through the paper's multiplier at ``draft_bits`` (the same
  weights, packed at that width once), a verify step runs the exact
  model over the ``k + 1``-row window in one forward and returns the
  exact argmax after each row, and the host keeps the longest agreeing
  prefix plus one exact token; a rollback step rewinds each slot to what
  it kept and zeroes the rest of its window. Every emitted token is an
  exact argmax over the prefix the sequential baseline sees, so streams
  are the baseline's; the draft decides only how many come a round. On
  the card the three steps are graph replays
  (``launch.steps.cached_draft_loop_step`` and its siblings), with one
  synchronize a round.
* *Evict*: a request leaves on EOS or length; its slot and pages free on
  the same step.

Codebook models (the audio family) take ``(S, K)`` prompts and emit a
``(K,)`` token a step, one per codebook, sampled from the step's ``(K,
V)`` logit row; their streams are ``(n, K)`` and stop on length only, as
in the reference. They take neither speculation nor the prefix cache.
The moe family speculates and, as in the reference, takes no prefix
cache; a step's tokens route as one group (its router's capacity
positions depend on the group), so its streams equal the baseline's
while no group drops a token.

*Mesh* (``mesh=``, a named ``("data", "model")`` ``DeviceMesh`` from
``launch.mesh.make_mesh`` over an initialized process group): the engine
serves through the reference's mesh-bound step builders
(``launch.mesh_steps``) on ``DTensor``s, as the reference's engine does on
its ``jax.sharding.Mesh``. Every rank builds the same engine and runs the
same requests (SPMD); the host schedule depends on token counts alone and
a sampled token on the request's own seeded generator, so every rank
takes the same decisions. The weights are placed by the builders'
parameter shardings and packed on the mesh, the pool (and each staging
cache) by their cache shardings; the cache operations write each rank's
shard (``models/cache_ops.py``), and the logits are gathered whole before
sampling. The steps run eagerly; a mesh with ``graphs=True``, or a
``device`` of another type than the mesh's, is refused. ``mesh=None``
keeps the one-device path above, the counterpart of the reference's 1x1
mesh (:func:`default_serving_mesh`).

Determinism: with SC-GEMM on, per-request streams equal the sequential
``launch.serve.generate`` baseline token for token — the projections are
integer-exact with per-row scales, and every float reduction on the path
is batch-invariant by construction (``models.layers``), on the CPU and on
the card alike, with SC attention (``cfg.attn_sc``) on or off.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.configs.base import sc_attention_bits_ok
from repro_torch.device import resolve_device
from repro_torch.errors import (CacheLayoutError, ConfigError,
                                EngineInvariantError)
from repro_torch.launch.steps import (DecodeStep, PrefillStep, bucket_for,
                                      cached_chunked_prefill_step,
                                      cached_decode_step,
                                      cached_draft_loop_step,
                                      cached_prefill_step,
                                      cached_rollback_step,
                                      cached_verify_window_step,
                                      prompt_buckets)
from repro_torch.launch.mesh import make_mesh, mesh_axes
from repro_torch.models import bind, cache_ops, pack_sc_weights
from repro_torch.models.transformer import params_to
from repro_torch.parallel.context import gathered

from .prefix import PrefixCache, PrefixMatch
from .queue import Request, RequestQueue, RequestResult
from .slots import PagedSlotPool, PoolExhausted, SlotEntry, SlotPool

__all__ = ["Engine", "default_serving_mesh"]

#: ``on_token(uid, index, token, finished_reason)`` — ``index`` is the
#: 0-based position in the stream, ``token`` a 0-d array (``(K,)`` with
#: codebooks); ``finished_reason`` is None until the
#: final token ("eos" / "length"). A preempted-and-readmitted request
#: replays its stream from index 0; ``Engine.stream`` dedupes by index.
TokenCallback = Callable[[str, int, np.ndarray, "str | None"], None]


def default_serving_mesh():
    """A 1x1 ``("data", "model")`` mesh over the current process group of
    one rank, on the card: ``Engine(cfg, params,
    mesh=default_serving_mesh())`` serves through the mesh-bound steps on
    one device. Without a process group, or in a group of more than one
    rank, it raises :class:`ConfigError`, as ``launch.mesh.make_mesh``
    does.

    The reference's engine always serves on a mesh, this one when no other
    is given. ``Engine(mesh=None)`` does not call this: its one-device path
    (a CUDA graph replay a step on the card) is the 1x1 mesh's
    counterpart, with the same streams, and needs no process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise ConfigError("a serving mesh needs a process group: call "
                          "torch.distributed.init_process_group first")
    if dist.get_world_size() != 1:
        raise ConfigError(f"the default serving mesh is 1x1; the process "
                          f"group holds {dist.get_world_size()} ranks: pass "
                          f"a mesh of that size")
    return make_mesh((1, 1), ("data", "model"))


@dataclass
class _StagingPrefill:
    """One in-flight chunked prefill: the queue head being committed, chunk
    by chunk, into the B=1 staging cache of its bucket's step. ``rows``
    holds the final chunk's logit row once complete. ``match`` is the
    prefix-cache plan of a hit: its pages stay pinned in the pool until
    admission or preemption, the staging cache was seeded from them and
    progress starts at ``match.resume``."""
    entry: SlotEntry
    bucket: int
    step: Any                    # a PrefillStep, or a MeshPrefillStep
    rows: np.ndarray | None = None
    match: PrefixMatch | None = None

    @property
    def done(self) -> bool:
        return self.entry.prefill_offset >= self.entry.request.prompt_len


class Engine:
    """Slot-pool serving engine over one bound model.

    ``capacity`` is the decode batch; ``max_seq`` bounds ``prompt +
    max_new`` per request. ``paged=True`` backs the pool with pages of
    ``block`` tokens under a budget of ``n_blocks`` pages (default no
    oversubscription); ``fused=False`` decodes through the gather → dense
    decode → commit round-trip instead of attending on the pages.
    ``continuous=False`` is static (gang) batching. ``prefill_mode`` is
    "chunked" (``chunk`` tokens per chunk, ``prefill_budget`` tokens per
    step) or "oneshot".

    ``device=None`` means the card; a machine without CUDA raises
    :class:`ConfigError` unless ``device="cpu"`` is asked for.
    ``graphs=None`` replays a captured CUDA graph a decode step, a prefill
    chunk or a one-shot prefill on the card and runs the steps eagerly on
    the CPU; ``graphs=False`` runs them eagerly on the card too (the A/B);
    ``graphs=True`` on the CPU raises :class:`ConfigError`. A graphed
    engine serves from its decode shape's cached step, which holds the
    weights, the KV pool and the prefill steps' staging buffers its graphs
    were captured over: binding it copies this engine's float weights in
    and packs them (unless the entry holds them already, unwritten since
    it was made or last bound) and empties the pool, and is refused while another engine holds
    requests in it (a staging prefill included). An engine whose step
    another engine has since bound binds it again on its next step, when
    it holds no request; a warm prefix tree does not survive that: the
    bind zeroed its pages, so the engine drops the tree and its retained
    pages with it, and its next prompts miss. SC attention
    (``cfg.attn_sc``) is served, in both prefill modes.

    ``prefix_cache=True`` (the default) shares block-aligned prompt
    prefixes across requests through the radix tree over the paged pool
    (DESIGN.md §12), where that is exact: paged layout, chunked prefill,
    dense family; elsewhere ``self.prefix`` is None. ``prefix_hash_seed``
    keys the block hash; streams do not depend on it.

    ``mesh`` (a named ``("data", "model")`` ``DeviceMesh``) serves through
    the mesh-bound step builders on ``DTensor``s, every rank running this
    engine with the same requests (module docstring); the device is the
    mesh's, the steps eager (``graphs=True``, or a ``device`` of another
    type, raises :class:`ConfigError`).

    ``speculate_k`` (default ``cfg.speculate_k``) > 0 serves by
    self-speculative rounds with drafts at ``draft_bits`` (default
    ``cfg.draft_bits``, 2..8); it needs the paged layout, a transformer
    family without codebooks (dense, moe, vlm) and greedy requests
    (others raise :class:`ConfigError`). Graphed, the
    draft, verify and rollback steps of the shape hang off the decode
    step, captured once when an engine first asks for them.
    """

    def __init__(self, cfg, params, *, capacity: int = 4, max_seq: int = 256,
                 mesh=None, device: str | torch.device | None = None,
                 continuous: bool = True, paged: bool = True, block: int = 64,
                 n_blocks: int | None = None, fused: bool = True,
                 prefill_mode: str = "chunked", chunk: int = 16,
                 prefill_budget: int | None = None,
                 prefix_cache: bool = True, prefix_hash_seed: int = 0,
                 speculate_k: int | None = None,
                 draft_bits: int | None = None,
                 graphs: bool | None = None):
        cfg.validate()
        if prefill_mode not in ("chunked", "oneshot"):
            raise ConfigError(f"unknown prefill_mode {prefill_mode!r}")
        self.speculate_k = cfg.speculate_k if speculate_k is None \
            else speculate_k
        self.draft_bits = cfg.draft_bits if draft_bits is None else draft_bits
        if self.speculate_k < 0:
            raise ConfigError(f"speculate_k must be >= 0, got "
                              f"{self.speculate_k}")
        if self.speculate_k:
            # the draft's scratch K/V and the rollback live in the page
            # pool, and only attention state can rewind (recurrent state
            # advances for good); codebook heads would need an acceptance
            # per codebook
            if not paged:
                raise ConfigError("speculative decoding requires the paged "
                                  "layout (rollback rewinds page cells)")
            if cfg.family in ("ssm", "hybrid") or cfg.n_codebooks:
                raise ConfigError(
                    f"speculative decoding needs a transformer family "
                    f"without codebooks (recurrent state cannot roll back), "
                    f"got family={cfg.family!r} "
                    f"n_codebooks={cfg.n_codebooks}")
            if not sc_attention_bits_ok(self.draft_bits):
                raise ConfigError(f"speculative draft needs 2 <= draft_bits "
                                  f"<= 8, got {self.draft_bits}")
        self.mesh = mesh
        if mesh is not None:
            mesh_axes(mesh)             # named axes, or ConfigError
            if graphs:
                raise ConfigError(
                    "graphs=True with a mesh: the mesh path runs its steps "
                    "eagerly on DTensors; pass graphs=None or False")
            if device is None:
                device = mesh.device_type
            if resolve_device(device).type != mesh.device_type:
                raise ConfigError(
                    f"device {device!r} is not the mesh's device type "
                    f"{mesh.device_type!r}")
            graphs = False
        self._m = bind(cfg, device)
        self.device = self._m.device
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.continuous = continuous
        self.paged = paged
        self.fused = fused and paged
        self.prefill_mode = prefill_mode
        if cfg.family in ("ssm", "hybrid"):
            # a chunk boundary must be an SSD chunk boundary, or the
            # recurrence would split where a one-shot prefill does not
            chunk = -(-chunk // cfg.ssm_chunk) * cfg.ssm_chunk
        self.chunk = chunk
        self.prefill_budget = chunk if prefill_budget is None \
            else prefill_budget
        self.buckets = prompt_buckets(max_seq, chunk)
        self.graphs = self.device.type == "cuda" if graphs is None \
            else graphs
        self._source = params
        if not self.graphs and mesh is None:
            # SC-GEMM weights are quantized and packed here, once per
            # engine; a graphed engine serves from its entry's one copy
            # (which copies the caller's weights in from wherever they
            # lie, so weights left on the host never have a second
            # device copy), a mesh engine from its decode step's, packed
            # on the mesh
            self._params = pack_sc_weights(params_to(params, self.device),
                                           cfg)

        max_blocks = None
        if paged:
            block, max_blocks, n_blocks = PagedSlotPool.plan(
                capacity, max_seq, block, n_blocks)
        cache = None
        if mesh is not None:
            from repro_torch.launch.mesh_steps import MeshDecodeStep
            self._decode = MeshDecodeStep(
                cfg, mesh, params, capacity=capacity, max_seq=max_seq,
                max_blocks=max_blocks, block=block, n_blocks=n_blocks,
                fused=self.fused)
            self._params, cache = self._decode.params, self._decode.cache
        elif self.graphs:
            self._decode = cached_decode_step(
                self._m, params, capacity=capacity, max_seq=max_seq,
                block=block, n_blocks=n_blocks, max_blocks=max_blocks,
                fused=self.fused)
            self._bind_decode(params)
            self._params, cache = self._decode.params, self._decode.cache
        if paged:
            self.pool: Any = PagedSlotPool(self._m, capacity, max_seq,
                                           block=block, n_blocks=n_blocks,
                                           cache=cache)
        else:
            self.pool = SlotPool(self._m, capacity, max_seq, cache=cache)
        if not self.graphs and mesh is None:
            self._decode = DecodeStep(self._m, self._params, self.pool.cache,
                                      capacity=capacity,
                                      max_blocks=max_blocks, block=block,
                                      fused=self.fused)
        self.prefix: PrefixCache | None = None
        self._prefix_hash_seed = prefix_hash_seed
        if (prefix_cache and paged and prefill_mode == "chunked"
                and cfg.family == "dense"):
            # a seeded staging row must be the row a cold prefill computes:
            # the staging caches and the pool hold K/V in one dtype
            staging = self._m.init_cache(1, 1).k[0].dtype
            if staging != self.pool.cache.k[0].dtype:
                raise EngineInvariantError(
                    f"prefix sharing needs the staging cache ({staging}) "
                    f"and the pool ({self.pool.cache.k[0].dtype}) in one "
                    f"dtype")
            self._new_prefix()
        if self.speculate_k:
            self._make_spec_steps()

        # host staging of the step's inputs: pinned on the card, so their
        # copies to the step's static buffers do not wait on the host
        pin = self.device.type == "cuda"
        # (capacity, 1), or (capacity, 1, K) with codebooks, as the step's
        self._tok_host = torch.zeros(self._decode.tokens.shape,
                                     dtype=torch.int32, pin_memory=pin)
        kb = self._decode.tokens.shape[2:]
        self._tok_buf = self._tok_host.numpy()
        self._tables_host = None if not paged else torch.zeros(
            (capacity, max_blocks), dtype=torch.int32, pin_memory=pin)
        # a prompt, zero-padded to its bucket, and each chunk's valid
        # length, written once a prompt; _copied marks the last copy out
        # of them, which a new prompt waits for before it overwrites them
        self._prompt_host = torch.zeros((1, self.buckets[-1], *kb),
                                        dtype=torch.int32, pin_memory=pin)
        self._nv_host = torch.zeros((self.buckets[-1] // chunk,),
                                    dtype=torch.int32, pin_memory=pin)
        self._copied = torch.cuda.Event() if pin else None
        self.queue = RequestQueue()
        self.stats: dict[str, Any] = {}
        self._step = 0          # decode-step counter (admissions are free)
        self._n_prefills = 0
        self._n_prefill_chunks = 0
        self._n_preemptions = 0
        self._admit_counter = 0
        self._staging: _StagingPrefill | None = None
        self._results: dict[str, RequestResult] = {}
        self._callbacks: dict[str, TokenCallback] = {}
        self._first_token_at: dict[str, float] = {}
        self._prefill_shapes: set[tuple[int, int]] = set()
        self._last_decode_end: float | None = None
        self._max_decode_gap = 0.0
        self._decode_s = 0.0
        self._n_prefix_hits = 0
        self._n_prefix_misses = 0
        self._prefill_tokens_saved = 0
        self._n_spec_rounds = 0
        self._spec_drafted = 0          # draft tokens proposed (live slots)
        self._spec_draft_accepted = 0   # draft tokens that reached a stream
        self._spec_emitted = 0          # tokens rounds put on the streams
        self._spec_draft_s = 0.0
        self._spec_verify_s = 0.0
        self._backpressure: dict[str, list[dict]] = {"admission": [],
                                                     "decode": []}

    def _new_prefix(self) -> None:
        """An empty radix tree, wired into the pool."""
        self.prefix = PrefixCache(block=self.pool.block,
                                  seed=self._prefix_hash_seed,
                                  align=self.chunk)
        self.pool.prefix = self.prefix

    def _make_spec_steps(self) -> None:
        """The draft, verify and rollback steps over the decode step's
        pool, kept on the decode step: graphed, the cached entry's
        (captured now, while the bound pool is empty); eager, the
        engine's own step's, uncaptured. The draft holds the weights
        packed at ``draft_bits``. Pinned host buffers take the round's
        two token grids and its accept counts; on the card, CUDA events
        time the draft and verify replays."""
        k, width = self.speculate_k, self.speculate_k + 1
        d = self._decode
        if self.mesh is not None:
            self._draft, self._verify, self._rollback = d.spec_steps(
                k=k, draft_bits=self.draft_bits)
        else:
            self._verify = cached_verify_window_step(d, width=width)
            self._draft = cached_draft_loop_step(d, k=k,
                                                 draft_bits=self.draft_bits)
            self._rollback = cached_rollback_step(d, width=width)
        pin = self.device.type == "cuda"
        self._window_host, self._exact_host = (
            torch.zeros((self.capacity, width), dtype=torch.int32,
                        pin_memory=pin) for _ in range(2))
        self._accept_host = torch.zeros((self.capacity,), dtype=torch.int32,
                                        pin_memory=pin)
        self._spec_events = [torch.cuda.Event(enable_timing=True)
                             for _ in range(3)] if pin else None

    def spec_steps(self) -> dict[str, Any]:
        """The draft, verify and rollback steps this engine replays."""
        if not self.speculate_k:
            return {}
        return {"draft": self._draft, "verify": self._verify,
                "rollback": self._rollback}

    # ------------------------------------------------------------ plumbing

    @property
    def has_work(self) -> bool:
        """Anything queued, staging, or live in a slot."""
        return (bool(self.queue) or bool(self.pool.entries)
                or self._staging is not None)

    def _check_request(self, req: Request) -> None:
        want = tuple(self._decode.tokens.shape[2:])     # (K,) or ()
        if req.prompt.shape[1:] != want:
            raise ConfigError(
                f"request {req.uid!r}: a prompt of {self.cfg.name} is "
                f"{'(S, %d)' % want[0] if want else '(S,)'} token ids, got "
                f"{req.prompt.shape}")
        if (self.prefill_mode == "oneshot"
                and self.cfg.family in ("ssm", "hybrid")
                and req.prompt_len % self.cfg.ssm_chunk):
            # the one-shot SSD scan takes whole chunks, as the reference's
            # does; chunked prefill pads a final chunk itself
            raise ConfigError(
                f"request {req.uid!r}: one-shot prefill of the "
                f"{self.cfg.family} family needs a prompt length that is a "
                f"multiple of ssm_chunk={self.cfg.ssm_chunk}, got "
                f"{req.prompt_len}")
        self.pool.check_fits(req)
        # the acceptance rule compares exact and draft argmaxes: a sampled
        # stream has no one right token to accept against
        if self.speculate_k and req.temperature > 0:
            raise ConfigError(
                f"request {req.uid!r}: speculative decoding accepts greedy "
                f"(temperature == 0) requests only, got "
                f"temperature={req.temperature}")

    def _rows(self, logits: torch.Tensor) -> np.ndarray:
        # a copy: the decode step's logits buffer is overwritten each step;
        # a mesh step's logits are read whole on every rank
        return gathered(logits)[:, -1].to("cpu", torch.float32,
                                          copy=True).numpy()

    @property
    def _holds_requests(self) -> bool:
        return bool(self.pool.entries) or self._staging is not None

    def _bind_decode(self, params) -> None:
        """Make the cached decode step serve this engine: its weights
        become ``params`` and its pool empty."""
        d = self._decode
        other = None if d.owner is None else d.owner()
        if other is not None and other is not self and other._holds_requests:
            raise ConfigError("the decode step of this shape serves another "
                              "engine that holds requests; drain it first "
                              "or pass graphs=False")
        d.load(params, draft_bits=self.draft_bits if self.speculate_k
               else None)
        d.reset()
        d.owner = weakref.ref(self)

    def _sample(self, entry: SlotEntry, row: np.ndarray) -> np.ndarray:
        """One token from a logit row ``(V,)``, or one per codebook from a
        ``(K, V)`` row. Greedy is argmax; temperature > 0 draws from a
        per-request ``torch.Generator`` seeded by the request, in codebook
        order, so the stream depends on the request alone."""
        req = entry.request
        if req.temperature <= 0:
            return np.argmax(row, axis=-1).astype(np.int32)
        if entry.generator is None:
            entry.generator = torch.Generator().manual_seed(req.seed)
        probs = torch.softmax(torch.as_tensor(row, dtype=torch.float64)
                              / req.temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=entry.generator)
        return tok.reshape(row.shape[:-1]).numpy().astype(np.int32)

    def _finish_reason(self, entry: SlotEntry, tok: np.ndarray) -> str | None:
        req = entry.request
        # a codebook frame has no one EOS id: it stops on length alone
        if (req.eos_id is not None and tok.ndim == 0
                and int(tok) == req.eos_id):
            return "eos"
        if entry.n_generated >= req.max_new_tokens:
            return "length"
        return None

    def _emit(self, slot: int, entry: SlotEntry, tok: np.ndarray) -> None:
        """Record a sampled token, push it to the request's stream, and
        finish + evict or park it for the next decode step."""
        entry.generated.append(tok)
        uid = entry.request.uid
        self._first_token_at.setdefault(uid, time.perf_counter())
        reason = self._finish_reason(entry, tok)
        cb = self._callbacks.get(uid)
        if cb is not None:
            cb(uid, entry.n_generated - 1, tok, reason)
        if reason is not None:
            self.pool.evict(slot)
            self._callbacks.pop(uid, None)
            req = entry.request
            self._results[uid] = RequestResult(
                uid=uid,
                tokens=np.stack(entry.generated).astype(np.int32),
                prompt_len=req.prompt_len,
                finished_reason=reason,
                enqueued_at=req.enqueued_at,
                admitted_at=entry.admitted_at,
                finished_at=time.perf_counter(),
                admit_step=entry.admit_step,
                finish_step=self._step,
                first_token_at=self._first_token_at.pop(uid),
            )
        else:
            self._tok_buf[slot] = tok

    # ------------------------------------------------------------ prefill

    def _stage_prompt(self, req: Request, width: int) -> None:
        """Write the prompt, zero-padded to ``width``, and each chunk's
        valid length into the pinned host buffers."""
        if self._copied is not None:
            # the previous prompt's copies out of these buffers have run (a
            # prompt's last logit row is read back, so this waits only for
            # a prompt preempted mid-prefill)
            self._copied.synchronize()
        n = req.prompt_len
        self._prompt_host.numpy()[0, :width] = 0
        self._prompt_host.numpy()[0, :n] = req.prompt
        nv = [min(self.chunk, n - off) for off in range(0, n, self.chunk)]
        self._nv_host.numpy()[:len(nv)] = nv

    def _copy_in(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src, non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def _prefill_captures(self) -> int:
        return sum(s.captures for s in self._decode.prefills.values())

    def prefill_steps(self) -> dict[tuple, PrefillStep]:
        """The prefill steps of this engine's decode entry, by shape:
        ``("chunked", bucket, chunk)`` or ``("oneshot", prompt_len)``."""
        return dict(self._decode.prefills)

    # ----------------------------------------------------- chunked prefill

    def _start_prefill(self, req: Request) -> _StagingPrefill:
        """Pop the queue head into a staging prefill of its bucket, on that
        bucket's step (its staging position back to 0); the entry is
        created now, so it is the youngest for preemption.

        With a prefix cache the prompt is matched first: on a hit the
        matched pages are pinned (the reclaimer cannot take them while the
        prompt stages), the staging cache is seeded with their K/V and the
        chunks start at the resume offset."""
        self.pool.check_fits(req)
        bucket = bucket_for(req.prompt_len, self.buckets)
        self._prefill_shapes.add((bucket, self.chunk))
        if self.mesh is not None:
            step = self._decode.prefill_step(extent=bucket, chunk=self.chunk)
        else:
            step = cached_chunked_prefill_step(self._decode, bucket=bucket,
                                               chunk=self.chunk)
        self._stage_prompt(req, bucket)
        step.start()
        entry = SlotEntry(request=req, admitted_at=0.0, admit_step=self._step,
                          admit_index=self._admit_counter)
        self._admit_counter += 1
        match = None
        if self.prefix is not None:
            plan = self.prefix.match(req.prompt)
            if plan.hit:
                match = plan
                self.pool.pin_pages(plan.pages)
                step.seed(self.pool.cache, plan.pages, block=self.pool.block,
                          resume=plan.resume)
                entry.prefill_offset = plan.resume
                self._n_prefix_hits += 1
            else:
                self._n_prefix_misses += 1
        return _StagingPrefill(entry=entry, bucket=bucket, step=step,
                               match=match)

    def _prefill_chunk_once(self, st: _StagingPrefill) -> None:
        """Commit one chunk of the staging prompt (the final chunk is
        zero-padded past its real tokens)."""
        req, step = st.entry.request, st.step
        off = st.entry.prefill_offset
        if off + self.chunk > st.bucket:
            raise CacheLayoutError(f"chunk [{off}, {off + self.chunk}) "
                                   f"overruns the staging extent {st.bucket}")
        i = off // self.chunk
        step.tokens.copy_(self._prompt_host[:, off:off + self.chunk],
                          non_blocking=True)
        self._copy_in(step.n_valid, self._nv_host[i:i + 1])
        step.replay()
        st.entry.prefill_offset = off + min(self.chunk, req.prompt_len - off)
        self._n_prefill_chunks += 1
        if st.done:
            st.rows = self._rows(step.logits)[0]

    def _can_admit_staged(self, st: _StagingPrefill) -> bool:
        if not self.pool.has_free:
            return False
        if not self.paged:
            return True
        return self.pool.can_admit(st.entry.request, match=st.match)

    def _admit_staged(self) -> None:
        """Completed staging prefill → pool admission: truncate the bucket
        padding to the prompt, insert, and emit the first token from the
        held final-chunk logits. A prefix hit admits through
        ``admit_prefix`` (attach, copy-on-write) and drops the CoW source's
        pin; either way the prompt's full pages enter the radix tree."""
        st = self._staging
        self._staging = None
        req = st.entry.request
        # the pool copies the prompt's K/V out of the staging cache now, in
        # stream order before any later replay of its step
        single = cache_ops.truncate_seq(st.step.cache, req.prompt_len)
        st.entry.admitted_at = time.perf_counter()
        st.entry.admit_step = self._step
        if st.match is not None:
            slot = self.pool.admit_prefix(st.entry, single, st.match)
            if st.match.cow_src is not None:
                self.pool.unpin_pages([st.match.cow_src])
            # counted at admission: a preempted staging prefill re-stages
            # and matches again, and must not count its resume twice
            self._prefill_tokens_saved += st.match.resume
        else:
            slot = self.pool.admit(st.entry, single)
        if self.prefix is not None:
            full = req.prompt_len // self.pool.block
            new = self.prefix.insert(req.prompt,
                                     self.pool.tables[slot, :full].tolist())
            self.pool.retain_pages(new)
        self._n_prefills += 1
        self._emit(slot, st.entry, self._sample(st.entry, st.rows))

    def _advance_prefill(self, budget_tokens: int) -> None:
        """Spend up to ``budget_tokens`` of prefill-chunk work and admit the
        staging prompt the moment it completes and fits; a completed but
        unadmittable prompt is held while the live slots decode."""
        chunks_left = max(1, budget_tokens // self.chunk)
        while True:
            if self._staging is None:
                if not self.queue:
                    return
                self._staging = self._start_prefill(self.queue.pop())
            st = self._staging
            while not st.done and chunks_left > 0:
                self._prefill_chunk_once(st)
                chunks_left -= 1
            if not st.done:
                return
            if not self._can_admit_staged(st):
                self._note_backpressure("admission", st.entry.request.uid)
                return
            self._admit_staged()
            if chunks_left <= 0:
                return

    # --------------------------------------------------- one-shot admission

    def _may_admit_next(self) -> bool:
        if not self.paged:
            return True
        return self.pool.can_admit(self.queue.peek())

    def _admit_one(self, req: Request) -> None:
        n = req.prompt_len
        self._prefill_shapes.add((n, 0))
        if self.mesh is not None:
            step = self._decode.prefill_step(extent=n)
        else:
            step = cached_prefill_step(self._decode, prompt_len=n)
        self._stage_prompt(req, n)
        self._copy_in(step.tokens, self._prompt_host[:, :n])
        step.replay()
        rows = self._rows(step.logits)
        entry = SlotEntry(request=req, admitted_at=time.perf_counter(),
                          admit_step=self._step,
                          admit_index=self._admit_counter,
                          prefill_offset=req.prompt_len)
        self._admit_counter += 1
        self._n_prefills += 1
        slot = self.pool.admit(entry, step.cache)
        self._emit(slot, entry, self._sample(entry, rows[0]))

    # ----------------------------------------------------------- the pool

    def _preempt_youngest(self) -> None:
        """Evict the most recently admitted slot — or drop the in-flight
        staging prefill if it is younger — and re-queue its request."""
        cands: list[tuple[int, int | None]] = [
            (e.admit_index, s) for s, e in self.pool.entries.items()]
        if self._staging is not None:
            cands.append((self._staging.entry.admit_index, None))
        _, victim = max(cands, key=lambda t: t[0])
        if victim is None:
            st = self._staging
            self._staging = None
            if st.match is not None:    # release the staging pins
                self.pool.unpin_pages(st.match.pages)
            self.queue.requeue(st.entry.request)
        else:
            entry = self.pool.evict(victim)
            self.queue.requeue(entry.request)
        self._n_preemptions += 1

    def _note_backpressure(self, reason: str, uid: str | None,
                           pages_needed: int | None = None,
                           pages_free: int | None = None) -> None:
        events = self._backpressure[reason]
        if events and events[-1]["uid"] == uid:
            return
        if pages_free is None and self.paged:
            pages_free = self.pool.free_pages
        events.append({"uid": uid, "pages_needed": pages_needed,
                       "pages_free": pages_free})

    def _grow_pages(self, width: int = 1) -> None:
        """Allocate each live slot's next ``width`` write positions' pages,
        oldest first, preempting youngest-first under pressure. A
        speculative window (``width > 1``) ensures only the positions a
        slot can still keep, ``min(width, remaining)``: its overshoot past
        the request's budget resolves to the trash page and is zeroed by
        the rollback."""
        for slot in sorted(self.pool.entries,
                           key=lambda s: self.pool.entries[s].admit_index):
            while slot in self.pool.entries:
                entry = self.pool.entries[slot]
                n_keep = min(width, entry.request.max_new_tokens
                             - entry.n_generated)
                base = entry.next_write_pos
                try:
                    for i in range(n_keep):
                        self.pool.ensure_page(slot, base + i)
                    break
                except PoolExhausted as e:
                    self._note_backpressure(e.reason, e.uid,
                                            e.pages_needed, e.pages_free)
                    if len(self.pool.entries) <= 1 and self._staging is None:
                        # nothing to preempt: a warm page the lone slot's
                        # own pages pin is all that can still be freed
                        if self.pool.reclaim_pinned():
                            continue
                        raise   # run() pre-check makes this unreachable
                    self._preempt_youngest()

    def _copy_step_inputs(self, width: int = 1) -> None:
        """Grow the pages and copy the block table and the last sampled
        tokens into the decode step's static buffers."""
        d = self._decode
        if self.paged:
            self._grow_pages(width)
            self._tables_host.numpy()[:] = self.pool.tables
            d.tables.copy_(self._tables_host, non_blocking=True)
        d.tokens.copy_(self._tok_host, non_blocking=True)

    def _decode_done(self, t0: float) -> None:
        now = time.perf_counter()
        self._step += 1
        self._decode_s += now - t0
        if self._last_decode_end is not None:
            self._max_decode_gap = max(self._max_decode_gap,
                                       now - self._last_decode_end)
        self._last_decode_end = now

    def _decode_once(self) -> np.ndarray:
        """One batched decode step over every slot; returns the ``(C, V)``
        last-token logit rows. The inputs go into the step's static
        buffers and the step advances the pool's positions in place."""
        t0 = time.perf_counter()
        self._copy_step_inputs()
        self._decode.replay()
        rows = self._rows(self._decode.logits)
        self._decode_done(t0)
        return rows

    def _speculate_once(self) -> None:
        """One draft → verify → rollback round over every slot, emitting 1
        to ``k + 1`` exact tokens a live slot.

        A slot at write position ``p`` (its last sampled token τ, whose
        K/V is not yet written):

        1. *Draft*: ``k`` sub-steps at ``draft_bits`` propose ``d_1..d_k``
           from τ, writing scratch K/V at ``[p, p + k)``; positions return
           to ``p``.
        2. *Verify*: the exact ``k + 1``-row window ``[τ, d_1..d_k]``
           rewrites ``[p, p + k]`` with exact K/V before any row attends,
           commits it to the pages and gives the exact argmaxes
           ``e_0..e_k``. Both grids come to the host in one synchronize.
        3. *Accept* (host): ``j`` is the longest prefix with ``e_i ==
           d_{i+1}``; the slot emits ``e_0..e_j``, capped at its remaining
           budget.
        4. *Rollback*, before any eviction changes the pool: positions
           rewind to ``p`` plus what was kept and the rest of the window is
           zeroed; a free slot rewinds its whole window (written to the
           trash page).
        """
        k = self.speculate_k
        t0 = time.perf_counter()
        self._copy_step_inputs(k + 1)
        ev = self._spec_events
        td = time.perf_counter()
        if ev:
            ev[0].record()
        self._draft.replay()
        if ev:
            ev[1].record()
        t1 = time.perf_counter()
        self._verify.replay()
        if ev:
            ev[2].record()
        self._window_host.copy_(self._verify.window, non_blocking=True)
        self._exact_host.copy_(self._verify.out, non_blocking=True)
        if ev:
            torch.cuda.current_stream(self.device).synchronize()
            self._spec_draft_s += ev[0].elapsed_time(ev[1]) / 1e3
            self._spec_verify_s += ev[1].elapsed_time(ev[2]) / 1e3
        else:
            self._spec_draft_s += t1 - td
            self._spec_verify_s += time.perf_counter() - t1
        draft, exact = self._window_host.numpy()[:, 1:], \
            self._exact_host.numpy()
        self._n_spec_rounds += 1

        accept = self._accept_host.numpy()
        accept[:] = 0
        agreed: dict[int, int] = {}
        for slot, entry in self.pool.entries.items():
            j = 0
            while j < k and exact[slot, j] == draft[slot, j]:
                j += 1
            agreed[slot] = j
            accept[slot] = min(j + 1, entry.request.max_new_tokens
                               - entry.n_generated)
            self._spec_drafted += k
        self._rollback.accept.copy_(self._accept_host, non_blocking=True)
        self._rollback.replay()
        for slot in self.pool.active_slots:
            entry = self.pool.entries[slot]
            for i in range(accept[slot]):
                self._emit(slot, entry, exact[slot, i])
                # what reached the stream: a token past EOS never does
                self._spec_emitted += 1
                self._spec_draft_accepted += i < agreed[slot]
                if slot not in self.pool.entries:
                    break       # finished: eviction reset its position
        self._decode_done(t0)

    # ------------------------------------------------------ the scheduler

    def step(self) -> bool:
        """One scheduler step: ≤ ``prefill_budget`` tokens of prefill work
        (admitting completed prompts), then one batched decode over the live
        slots. Returns whether work remains."""
        if not self.has_work:
            return False
        if self.graphs and self._decode.owner() is not self:
            # another engine of this shape bound the step since, and emptied
            # the pool: this one holds no request (that engine's bind
            # refuses otherwise), so it binds the step back. Its warm
            # prefix pages were zeroed by that bind: the tree and its
            # retained pages go, or the next hit would read zeros
            self._bind_decode(self._source)
            if self.prefix is not None:
                self.pool.drop_retained()
                self._new_prefix()
        if self.prefill_mode == "chunked":
            if self.continuous:
                self._advance_prefill(self.prefill_budget)
            elif not self.pool.entries:
                self._advance_prefill(self.max_seq * self.capacity)
        else:
            may_admit = self.continuous or not self.pool.entries
            while may_admit and self.pool.has_free and self.queue \
                    and self._may_admit_next():
                self._admit_one(self.queue.pop())
                if not self.continuous and not self.pool.has_free:
                    break
        if not self.pool.entries:
            st = self._staging
            if (st is not None and st.done and st.match is not None
                    and not self._can_admit_staged(st)):
                # the sharing plan itself can pin the capacity admission
                # needs (warm pages and the CoW source are off the free list
                # while staged): drop it — the staging cache is complete and
                # its seeded rows are what a cold prefill computes — and
                # admit privately, as a miss would be. The skipped span still
                # counts as saved: it was never recomputed.
                self.pool.unpin_pages(st.match.pages)
                self._prefill_tokens_saved += st.match.resume
                st.match = None
                if self._can_admit_staged(st):
                    self._admit_staged()
        if not self.pool.entries:
            # an empty pool has every slot and page free (or reclaimable),
            # so anything still refused now can never be admitted — fail,
            # don't spin
            st = self._staging
            if st is not None and st.done and not self._can_admit_staged(st):
                self._staging = None
                raise PoolExhausted(
                    f"request {st.entry.request.uid!r} cannot be admitted "
                    f"even into an empty pool", uid=st.entry.request.uid)
            if (self.prefill_mode == "oneshot" and self.queue
                    and not self._may_admit_next()):
                raise PoolExhausted(
                    f"request {self.queue.peek().uid!r} cannot be admitted "
                    f"even into an empty pool", uid=self.queue.peek().uid)
            return self.has_work
        if self.speculate_k:
            self._speculate_once()
            return self.has_work
        rows = self._decode_once()
        for slot in self.pool.active_slots:
            entry = self.pool.entries[slot]
            self._emit(slot, entry, self._sample(entry, rows[slot]))
        return self.has_work

    # ------------------------------------------------- streaming surface

    def submit(self, request: Request,
               on_token: TokenCallback | None = None) -> None:
        """Queue a request; ``on_token`` receives every emitted token
        (including post-preemption replays). Unfittable requests are
        refused here, before any device work."""
        self._check_request(request)
        self.queue.submit(request)
        if on_token is not None:
            self._callbacks[request.uid] = on_token

    def stream(self, request: Request) -> Iterator[np.ndarray]:
        """Submit ``request`` and yield its tokens as they are generated,
        driving the engine; replayed indexes after a preemption are
        deduped, so each token is seen once."""
        buf: list[tuple[int, np.ndarray]] = []
        done: list[str] = []

        def on_token(uid, index, tok, reason):
            buf.append((index, tok))
            if reason is not None:
                done.append(reason)

        self.submit(request, on_token=on_token)
        nxt = 0
        while True:
            while buf:
                index, tok = buf.pop(0)
                if index == nxt:
                    nxt += 1
                    yield tok
            if done:
                self._results.pop(request.uid, None)
                return
            self.step()
            if not self.has_work and not buf and not done:
                raise EngineInvariantError(
                    f"engine drained without finishing {request.uid!r}")

    # ----------------------------------------------------------- the loop

    def run(self, requests: Sequence[Request] = ()) -> list[RequestResult]:
        """Drain ``requests`` (plus anything already queued); returns
        results in submission order and fills ``self.stats``."""
        for r in requests:
            self._check_request(r)
        order = [r.uid for r in requests]
        for r in requests:
            self.queue.submit(r)
        t0 = time.perf_counter()
        steps0, prefills0 = self._step, self._n_prefills
        chunks0, preempt0 = self._n_prefill_chunks, self._n_preemptions
        decode0, captures0 = self._decode_s, self._prefill_captures()
        hits0, misses0 = self._n_prefix_hits, self._n_prefix_misses
        saved0 = self._prefill_tokens_saved
        cow0 = getattr(self.pool, "n_cow", 0)
        reclaim0 = getattr(self.pool, "n_reclaimed", 0)
        spec0 = (self._n_spec_rounds, self._spec_drafted,
                 self._spec_draft_accepted, self._spec_emitted,
                 self._spec_draft_s, self._spec_verify_s)
        self._backpressure = {"admission": [], "decode": []}
        self._last_decode_end = None
        self._max_decode_gap = 0.0

        while self.step():
            pass

        wall = time.perf_counter() - t0
        if order:
            out = [self._results.pop(uid) for uid in order]
        else:
            out = sorted(self._results.values(), key=lambda r: r.admitted_at)
            self._results.clear()
        generated = sum(r.n_generated for r in out)

        def pctl(values, q):
            v = sorted(values) or [0.0]
            if q == 0.5:
                return v[len(v) // 2]
            return v[min(len(v) - 1, int(np.ceil(q * len(v))) - 1)]

        lats = [r.latency_s for r in out]
        ttfts = [r.ttft_s for r in out]
        itls = [r.itl_s for r in out if r.n_generated > 1]
        steps = self._step - steps0
        self.stats = {
            "mode": "continuous" if self.continuous else "static",
            "layout": "paged" if self.paged else "contiguous",
            "decode_graphs": self.graphs,
            "prefill_captures": self._prefill_captures() - captures0,
            "prefill_mode": self.prefill_mode,
            "device": str(self.device),
            "mesh": None if self.mesh is None else mesh_axes(self.mesh),
            "requests": len(out),
            "generated_tokens": generated,
            "decode_steps": steps,
            "decode_s": self._decode_s - decode0,
            "decode_ms_per_step": ((self._decode_s - decode0) * 1e3
                                   / max(steps, 1)),
            "prefills": self._n_prefills - prefills0,
            "prefill_chunks": self._n_prefill_chunks - chunks0,
            "preemptions": self._n_preemptions - preempt0,
            "wall_s": wall,
            "tok_per_s": generated / wall if wall > 0 else float("inf"),
            "p50_latency_s": pctl(lats, 0.5),
            "p99_latency_s": pctl(lats, 0.99),
            "ttft_p50_s": pctl(ttfts, 0.5),
            "ttft_p99_s": pctl(ttfts, 0.99),
            "itl_p50_s": pctl(itls, 0.5),
            "itl_p99_s": pctl(itls, 0.99),
            "max_decode_gap_s": self._max_decode_gap,
            "chunk": self.chunk,
            "buckets": self.buckets,
            "prefill_shapes": len(self._prefill_shapes),
            "prefix_cache": self.prefix is not None,
            "speculative": bool(self.speculate_k),
            "attn_sc_bits": self.cfg.sc_bits if self.cfg.attn_sc else None,
        }
        if self.speculate_k:
            rounds = self._n_spec_rounds - spec0[0]
            drafted = self._spec_drafted - spec0[1]
            accepted = self._spec_draft_accepted - spec0[2]
            per = 1e6 / max(rounds, 1)
            self.stats.update({
                "speculate_k": self.speculate_k,
                "draft_bits": self.draft_bits,
                "spec_rounds": rounds,
                "spec_drafted_tokens": drafted,
                "spec_accepted_tokens": accepted,
                "spec_acceptance_rate": accepted / max(drafted, 1),
                "spec_tokens_per_round": (self._spec_emitted - spec0[3])
                / max(rounds, 1),
                "spec_draft_us": (self._spec_draft_s - spec0[4]) * per,
                "spec_verify_us": (self._spec_verify_s - spec0[5]) * per,
            })
        if self.paged:
            self.stats.update({
                "block": self.pool.block,
                "n_blocks": self.pool.n_blocks,
                "pages_in_use": self.pool.pages_in_use,
                "pages_live": self.pool.pages_live,
                "peak_pages": self.pool.peak_pages,
                "decode_path": "fused" if self.fused else "gather",
                "backpressure": self._backpressure,
            })
        if self.prefix is not None:
            hits = self._n_prefix_hits - hits0
            misses = self._n_prefix_misses - misses0
            self.stats.update({
                "prefix_hits": hits,
                "prefix_misses": misses,
                "prefix_hit_rate": hits / max(hits + misses, 1),
                "prefill_tokens_saved":
                    self._prefill_tokens_saved - saved0,
                "cow_copies": self.pool.n_cow - cow0,
                "prefix_reclaims": self.pool.n_reclaimed - reclaim0,
                "prefix_retained_pages": len(self.pool.retained),
            })
        return out
