"""KV-cache serving engines (port of ``repro/serve/engine.py``): the
fixed-batch ``ServeEngine`` and ``serve_step``, and continuous batching,
``ContinuousBatchingEngine`` over ``Request``s with ``_sample_rows``.

``generate`` prefills the prompts, samples the first token from the
prefill logits, then runs exactly ``max_new_tokens - 1`` decode steps.

Non-finite guard: a row with any NaN/inf logit takes token 0 instead of
sampling from NaN, and ``generate(..., return_flags=True)`` reports which
rows ever hit the guard.  Rows never mix, so a poisoned request flags only
itself.

``generate``'s sampling noise comes from a ``torch.Generator``, so
temperature > 0 does not reproduce the reference's ``jax.random`` tokens;
greedy decoding does.  The continuous engine's sampling is a pure rule fed
its noise (``_sample_rows``): given the reference's own Gumbel draws it
gives the reference's tokens bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import causal_lm as LM
from repro_torch.models import transformer as T

__all__ = ["ServeEngine", "serve_step", "sample", "Request",
           "ContinuousBatchingEngine", "gumbel_noise"]


def serve_step(params, cfg: T.ModelConfig, tokens: torch.Tensor, cache,
               cache_index: int):
    """One decode step for the whole batch: (B,) -> (logits (B, V), cache)."""
    return LM.decode_step(params, cfg, tokens, cache, cache_index)


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(tokens (B,), bad (B,) bool)``: argmax for
    ``temperature <= 0``, else a draw from softmax(logits / temperature);
    rows with a non-finite logit are flagged and take token 0."""
    bad = ~torch.isfinite(logits).all(dim=-1)
    safe = torch.where(bad[:, None], torch.zeros_like(logits), logits)
    if temperature <= 0:
        return torch.argmax(safe, dim=-1), bad
    probs = torch.softmax(safe.float() / temperature, dim=-1)
    tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(bad, torch.zeros_like(tok), tok), bad


@dataclasses.dataclass
class ServeEngine:
    """Greedy or temperature generation for a batch of prompts.

    ``device`` is ``cuda`` unless the caller passes another; the params
    must already lie there.  TF32 matrix products are switched off so the
    f32 logits of ``unembed`` are full f32, as in the reference."""

    cfg: T.ModelConfig
    params: torch.nn.Module
    max_len: int
    cache_dtype: torch.dtype = torch.bfloat16
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for p in self.params.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"params lie on {p.device}, the engine runs "
                                 f"on {self.device}: move them first")
            break
        torch.backends.cuda.matmul.allow_tf32 = False

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, *, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 return_flags: bool = False
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """prompts: (B, T_prompt) int -> tokens (B, max_new_tokens) int64;
        with ``return_flags`` also (B,) bool, True for rows that hit the
        non-finite guard at any step."""
        if temperature > 0 and generator is None:
            raise ValueError("temperature > 0 requires a torch.Generator")
        prompts = torch.as_tensor(prompts, device=self.device).long()
        B, T_prompt = prompts.shape
        if T_prompt + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"{T_prompt} + {max_new_tokens} tokens exceed "
                             f"max_len={self.max_len}")
        if max_new_tokens <= 0:
            empty = torch.zeros((B, 0), dtype=torch.long, device=self.device)
            flags = torch.zeros((B,), dtype=torch.bool, device=self.device)
            return (empty, flags) if return_flags else empty
        logits, cache = LM.prefill(self.params, self.cfg,
                                   max_len=self.max_len, tokens=prompts,
                                   cache_dtype=self.cache_dtype)
        tok, flags = sample(logits, temperature, generator)
        out = [tok]
        # the token sampled from step t's logits is decoded at step t+1;
        # the last sampled token is returned without a trailing decode
        for t in range(max_new_tokens - 1):
            logits, cache = serve_step(self.params, self.cfg, tok, cache,
                                       T_prompt + t)
            tok, bad = sample(logits, temperature, generator)
            flags = flags | bad
            out.append(tok)
        tokens = torch.stack(out, dim=1)
        return (tokens, flags) if return_flags else tokens


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One serving request for ``ContinuousBatchingEngine``.

    ``temperature <= 0`` is greedy; ``top_k <= 0`` (or >= vocab) and
    ``top_p`` outside (0, 1) disable those filters.  ``rid`` keys the
    request's sampling noise and its result; assigned in order when
    None."""

    prompt: object
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    rid: Optional[int] = None


def _sample_rows(logits: torch.Tensor, noise: torch.Tensor,
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampling: ``argmax(filtered(logits / t) + noise)``, each row
    with its own temperature, top-k and top-p, (B,) tensors.

    ``noise`` (B, V) is standard Gumbel noise: ``jax.random.categorical``
    is exactly ``argmax(gumbel(key) + logits)``, so fed the reference's own
    draws this gives its tokens.  Top-k keeps every logit ``>=`` the k-th
    largest (ties kept, as the reference does, not ``torch.topk``'s
    indices); top-p then keeps the smallest prefix of the sorted
    probabilities whose mass reaches p.  Greedy rows (``t <= 0``) take the
    argmax; a row with a non-finite logit takes token 0 and is flagged in
    the returned ``bad``.  Per-row math only: a row's token does not depend
    on its neighbours.  Returns ``(tokens (B,) int64, bad (B,) bool)``."""
    V = logits.shape[-1]
    bad = ~torch.isfinite(logits).all(dim=-1)
    safe = torch.where(bad[:, None], torch.zeros_like(logits), logits)
    greedy_tok = torch.argmax(safe, dim=-1)
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    scaled = safe.float() / t
    # top-k: the k-th largest logit is the threshold
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (top_k - 1).clamp(0, V - 1)[:, None])
    apply_k = ((top_k > 0) & (top_k < V))[:, None]
    scaled = torch.where(apply_k & (scaled < kth), -math.inf, scaled)
    # top-p over the k-filtered distribution: a token goes only if the
    # mass strictly above it already covers p
    desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    mass_above = torch.cumsum(probs, dim=-1) - probs
    kept = mass_above < top_p[:, None]
    thr = torch.where(kept, desc, math.inf).amin(dim=-1, keepdim=True)
    apply_p = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    scaled = torch.where(apply_p & (scaled < thr), -math.inf, scaled)
    sampled = torch.argmax(noise + scaled, dim=-1)
    tok = torch.where((temperature <= 0.0) | bad, greedy_tok, sampled)
    return tok, bad


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32), in int64 without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (Wellons' lowbias32), a bijection on
    [0, 2^32), in int64 tensor ops."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: int, rid: torch.Tensor, step: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Standard Gumbel noise (B, vocab) f32, a pure function of ``(seed,
    rid[b], step[b], v)``: integer hashes give every element's 23 bits
    (the same on every device), ``u = (k + 1/2) 2^-23`` lies strictly
    inside (0, 1), and ``-log(-log(u))`` is taken in f64 and rounded to
    f32, so a row's noise does not depend on its slot, its neighbours or
    how the device vectorizes the logarithm."""
    row = _mix32((_mix32(step & _M32) ^ (rid & _M32)) & _M32)
    row = _mix32(row ^ _mix32(torch.full_like(row, seed & _M32)))
    v = torch.arange(vocab, device=rid.device)
    h = _mix32(_mix32(v[None, :] ^ row[:, None]) ^ _mix32(row ^ 0x5BD1E995)
               [:, None])
    u = ((h >> 9).double() + 0.5) * 2.0 ** -23
    return (-torch.log(-torch.log(u))).float()


class ContinuousBatchingEngine:
    """Continuous batching over ``slots`` batch rows (port of the
    reference's engine): requests are admitted into free slots as they
    arrive and evicted when they have their ``max_new_tokens``, and every
    decode tick serves the whole pool.

    **The tick** always runs at ``slots`` rows.  Every per-request quantity
    lives in a (slots,) device tensor (last token, cache position, active
    flag, rid, step, temperature, top-k, top-p), each row decodes at its
    own position (``decode_step`` with a (slots,) ``cache_index``) and the
    state is updated in place, so across any churn the tick issues the
    same operations on the same shapes with no read back to the host; the
    engine reads the new tokens once, after it.  Inactive slots still
    decode, as in the reference, and their row is replaced whole at the
    next admit.  The tick is thus ready for capture in a CUDA graph (not
    done here).

    **Noise.** ``jax.random`` cannot be reproduced in torch, so sampling is
    the pure rule of ``_sample_rows`` fed Gumbel noise from
    ``gumbel_noise(seed, rid, step)``: a stateless integer hash, one set of
    launches for the whole tick, independent of the slot and the
    neighbours.  (One ``torch.Generator`` per request would cost a launch
    a row a tick.)  Token i of a request uses step i, as the reference
    folds its key.

    **Prefill** pads each prompt to its bucket (powers of two from 8,
    capped at ``max_len``) and prefills each request alone, one row,
    straight into its slot's row of the pool (the rest of the row zeroed;
    a sliding-window layer's ring row is written whole by the prefill,
    every slot from the request's own real positions), so the whole row is
    replaced and a poisoned tenant's NaN K/V never reaches the next: masked
    positions weigh ``0 * v``, and ``0 * NaN`` is NaN.  One row, not the bucket's group, keeps every prefill of a bucket
    at one shape: cuBLAS picks its algorithm by shape and the fused kernels
    plan by row count, so a group-sized prefill could change a request's
    bits with its neighbours.  It also does no work for padded rows; it
    costs a prefill's launches per request.

    **Churn parity** therefore holds at equal slot count: a request gives
    the same tokens, bit for bit, in a churning pool as alone in an engine
    with the same ``slots``.  Not under ``with_quantized_io``: rows there
    share an int8 scale block, so a request's tokens depend on its
    neighbours, as they do in the reference.

    Only attention-mixer stacks are supported: the chunked prefill and the
    per-row decode need KV caches.  ``device`` is ``cuda`` unless the
    caller passes another; on a CUDA tensor without built kernels the
    kernel wrappers raise: nothing decodes on the CPU quietly."""

    def __init__(self, cfg: T.ModelConfig, params, *, slots: int,
                 max_len: int, cache_dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, device=None):
        if any(s.mixer != "attn" for s in cfg.layers):
            raise ValueError(
                "ContinuousBatchingEngine needs an attention-only stack; "
                f"{cfg.name} has SSM mixers (use ServeEngine)")
        self.device = resolve_device(device)
        for p in params.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"params lie on {p.device}, the engine runs "
                                 f"on {self.device}: move them first")
            break
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.seed = seed
        self._next_rid = 0
        self._cache = None

    # ---- the pool's state ------------------------------------------------

    def _reset(self):
        S, dev = self.slots, self.device
        if self._cache is None:
            self._cache = T.init_cache(S, self.max_len, self.cfg, device=dev,
                                       dtype=self.cache_dtype)
        else:
            for c in self._cache:
                c["mixer"]["k"].zero_()
                c["mixer"]["v"].zero_()
        self._tok = torch.zeros(S, dtype=torch.long, device=dev)
        self._ci = torch.zeros(S, dtype=torch.long, device=dev)
        self._active = torch.zeros(S, dtype=torch.bool, device=dev)
        self._rid = torch.zeros(S, dtype=torch.long, device=dev)
        self._step = torch.zeros(S, dtype=torch.long, device=dev)
        self._temp = torch.zeros(S, dtype=torch.float32, device=dev)
        self._topk = torch.zeros(S, dtype=torch.long, device=dev)
        self._topp = torch.ones(S, dtype=torch.float32, device=dev)
        self._slot_req: list = [None] * S

    def _tick(self) -> torch.Tensor:
        """One decode tick over every slot; updates the pool's state in
        place and returns the (slots,) non-finite flags."""
        logits, _ = LM.decode_step(self.params, self.cfg, self._tok,
                                   self._cache, self._ci)
        noise = gumbel_noise(self.seed, self._rid, self._step,
                             logits.shape[-1])
        new_tok, bad = _sample_rows(logits, noise, self._temp, self._topk,
                                    self._topp)
        act = self._active
        self._tok.copy_(torch.where(act, new_tok, self._tok))
        self._ci.add_(act.long())
        self._step.add_(act.long())
        return bad

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _admit(self, batch, tick_idx, results):
        """Prefill each of ``batch`` [(slot, Request)] into its slot, in
        bucket order, sample its first token and set its slot's state; one
        read of the first tokens for the whole batch."""
        groups: dict = {}
        for slot, req in batch:
            prompt = torch.as_tensor(req.prompt).reshape(-1).long()
            groups.setdefault(self._bucket(prompt.shape[0]),
                              []).append((slot, req, prompt))
        V = self.cfg.vocab_size
        firsts = []
        for bucket, members in sorted(groups.items()):
            for slot, req, prompt in members:
                n = prompt.shape[0]
                toks = F.pad(prompt, (0, bucket - n)).to(self.device)[None]
                rows = []
                for c in self._cache:
                    row = {k: c["mixer"][k][slot: slot + 1]
                           for k in ("k", "v")}
                    row["k"][:, bucket:].zero_()
                    row["v"][:, bucket:].zero_()
                    rows.append({"mixer": row})
                logits, _ = LM.prefill(self.params, self.cfg,
                                       max_len=self.max_len, tokens=toks,
                                       length=n, cache=rows)
                rid = torch.tensor([req.rid], device=self.device)
                first, bad = _sample_rows(
                    logits, gumbel_noise(self.seed, rid,
                                         torch.zeros_like(rid), V),
                    torch.tensor([float(req.temperature)],
                                 device=self.device),
                    torch.tensor([int(req.top_k)], device=self.device),
                    torch.tensor([float(req.top_p)], device=self.device))
                self._tok[slot: slot + 1].copy_(first)
                self._ci[slot] = n
                self._rid[slot] = req.rid
                self._step[slot] = 1
                self._temp[slot] = req.temperature
                self._topk[slot] = req.top_k
                self._topp[slot] = req.top_p
                self._active[slot] = True
                self._slot_req[slot] = req
                firsts.append((req, torch.stack([first[0], bad[0].long()])))
        got = torch.stack([f for _, f in firsts]).tolist()
        for (req, _), (tok, bad) in zip(firsts, got):
            res = results[req.rid]
            res["tokens"].append(tok)
            res["flagged"] |= bool(bad)
            res["admitted_tick"] = tick_idx

    @torch.inference_mode()
    def serve(self, requests, *, arrival_ticks=None):
        """Serve ``requests`` (list of :class:`Request`) to completion.

        ``arrival_ticks[i]`` (default 0) is the decode tick at which request
        *i* becomes admissible.  Returns ``(results, stats)``: ``results``
        maps rid -> {tokens, flagged, admitted_tick, finished_tick};
        ``stats`` has ``ticks``, ``tokens`` (the prefill samples included)
        and ``occupied_slot_ticks``."""
        for r in requests:
            if r.rid is None:
                r.rid = self._next_rid
                self._next_rid += 1
            if r.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            n = torch.as_tensor(r.prompt).reshape(-1).shape[0]
            if n + r.max_new_tokens > self.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({n}) + max_new_tokens "
                    f"({r.max_new_tokens}) exceeds max_len={self.max_len}")
        arrival_ticks = list(arrival_ticks or [0] * len(requests))
        pending = sorted(zip(arrival_ticks, range(len(requests))))
        results = {r.rid: {"tokens": [], "flagged": False,
                           "admitted_tick": None, "finished_tick": None}
                   for r in requests}
        self._reset()
        stats = {"ticks": 0, "tokens": 0, "occupied_slot_ticks": 0}
        tick_idx = 0
        while pending or any(r is not None for r in self._slot_req):
            # admit arrivals into free slots
            free = [s for s in range(self.slots) if self._slot_req[s] is None]
            batch = []
            while pending and free and pending[0][0] <= tick_idx:
                _, i = pending.pop(0)
                batch.append((free.pop(0), requests[i]))
            if batch:
                self._admit(batch, tick_idx, results)
                # a max_new_tokens == 1 admit finishes without decoding
                for s, req in batch:
                    if len(results[req.rid]["tokens"]) >= req.max_new_tokens:
                        results[req.rid]["finished_tick"] = tick_idx
                        self._active[s] = False
                        self._slot_req[s] = None
                stats["tokens"] += len(batch)
            n_active = sum(r is not None for r in self._slot_req)
            if n_active:
                bad = self._tick()
                tok_h, bad_h = torch.stack([self._tok, bad.long()]).tolist()
                for s in range(self.slots):
                    req = self._slot_req[s]
                    if req is not None:
                        res = results[req.rid]
                        res["tokens"].append(tok_h[s])
                        res["flagged"] |= bool(bad_h[s])
                        if len(res["tokens"]) >= req.max_new_tokens:
                            res["finished_tick"] = tick_idx
                            self._active[s] = False
                            self._slot_req[s] = None
                stats["tokens"] += n_active
                stats["occupied_slot_ticks"] += n_active
            stats["ticks"] += 1
            tick_idx += 1
        return results, stats
