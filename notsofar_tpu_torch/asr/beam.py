"""Batched beam-search decoding for Whisper (beam_size=5 in the shipped
config).

Port of notsofar_tpu/asr/beam.py. A set-up (the prompt's prefill), then
one step function, in a workspace kept per key with three CUDA graphs
replayed on the card (GreedyDecoder._run_call, _run_steps), as the JAX
package's jitted _beam_scan is compiled once per shape; state is kept per
(batch, beam) in tensors updated in place: cumulative logprobs, finished
latches, per-beam timestamp-rule state, and the token buffer, which is
reordered with the same gather as the state (no host-side genealogy
backtracking).

The self-attention cache is split: a prompt segment [B, P, D] written
once at prefill and shared by each stream's K beams, and a generated
segment [B*K, G, D] per beam. Neither is ever gathered: beam reordering
updates a [B, K, G] int32 ancestry matrix (anc[b, j, s] = the physical
beam row whose slot-s K/V belongs to logical beam j's history), which
the attn_step_split kernel reads as visibility. Models whose head
geometry the kernel does not cover keep a unified cache that is gathered
every step.

Semantics follow whisper's BeamSearchDecoder: finished hypotheses
persist (eot self-loop contributing zero logprob), candidates are
expanded over K*V and pruned to the top K per batch element, and the
final hypothesis is chosen by length-normalized average logprob
(MaximumLikelihoodRanker with length_penalty=None).
"""
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from notsofar_tpu_torch.asr.decoding import (NEG_INF, DecodeOptions,
                                             DecodeWorkspace, GreedyDecoder)
from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
from notsofar_tpu_torch.models.whisper import WhisperModel
from notsofar_tpu_torch.utils.profiling import span


class BeamDecoder(GreedyDecoder):
    """Shares the logit filters with GreedyDecoder; adds beam expansion."""

    def __init__(self, model: WhisperModel, tokenizer: WhisperTokenizer,
                 options: DecodeOptions = DecodeOptions(),
                 beam_size: int = 5, cache_dtype=torch.bfloat16,
                 split_cache: bool = True):
        super().__init__(model, tokenizer, options)
        self.beam_size = beam_size
        self.cache_dtype = cache_dtype
        self.split_cache = split_cache

    def _zeros_caches(self, rows: int, ctx: int):
        d = self.model.dims
        return [tuple(torch.zeros((rows, ctx, d.n_text_state),
                                  dtype=self.cache_dtype,
                                  device=self.model.device)
                      for _ in range(2))
                for _ in range(d.n_text_layer)]

    @torch.no_grad()
    def _beam_loop(self, xa: torch.Tensor, prompt_len: int,
                   prompt_tokens: torch.Tensor,
                   pad_lens: Optional[torch.Tensor] = None,
                   graph: Optional[bool] = None):
        """xa: [B, 1500, D]; prompt_tokens: [B, P]. pad_lens: optional [B]
        left-pad widths for per-row prompts (see GreedyDecoder). graph: see
        GreedyDecoder._decode_loop (None: the key's CUDA graphs on the
        card). Returns (tokens [B, K, max_new], stats [B, 2K+1] = sum_lp ||
        length || no_speech_prob), tensors of their own."""
        t_call = time.perf_counter()
        model, tok = self.model, self.tok
        dev = xa.device
        K = self.beam_size
        B = xa.shape[0]
        BK = B * K
        V = model.dims.n_vocab
        d = model.dims
        use_split = (self.split_cache and d.n_text_state % 128 == 0
                     and d.n_text_state // d.n_text_head in (64, 128))
        max_new, cache_len = self._lengths(prompt_len)
        P = prompt_tokens.shape[1]
        sot_pos = self._sot_pos(prompt_len)
        if use_split:
            # the prompt is identical across a stream's K beams: prefill at
            # batch B into the shared prompt segment
            G = -(-max_new // 64) * 64
            pos0 = P
        else:
            G, pos0 = cache_len, prompt_len
        graph = xa.is_cuda if graph is None else bool(graph)

        def make() -> DecodeWorkspace:
            if use_split:
                anc = torch.zeros((B, K, G), dtype=torch.int32, device=dev)
                caches = [(kp, vp, kg, vg, anc) for (kp, vp), (kg, vg)
                          in zip(self._zeros_caches(B, P),
                                 self._zeros_caches(BK, G))]
            else:
                caches = self._zeros_caches(BK, G)
            eot_only = torch.full((V,), NEG_INF, device=dev)
            eot_only[self._eot] = 0.0
            return DecodeWorkspace(
                dev, 0, self._init_state(BK), caches=caches,
                tokens=torch.empty((BK, max_new), dtype=torch.long,
                                   device=dev),
                sum_lp=torch.empty(BK, dtype=torch.float32, device=dev),
                sum_lp0=torch.where(torch.arange(K, device=dev) == 0, 0.0,
                                    NEG_INF).repeat(B),
                step_t=torch.empty((), dtype=torch.long, device=dev),
                eot_only=eot_only,
                # anc[:, :, step] = j: each beam owns the slot it writes
                own_slot=torch.arange(K, dtype=torch.int32, device=dev)[
                    None, :, None].expand(B, K, 1).contiguous(),
                row0=torch.arange(B, device=dev)[:, None] * K)

        with span("stage.decode.prepare"):
            key = self._key(f"beam{K}", xa, graph, prompt_len, B, P, G,
                            max_new, use_split, self.cache_dtype,
                            pad_lens is not None)
            ws, fresh = self._workspace(key, make)
            ws.load(xa, prompt_tokens, pad_lens, ())
        t, st, caches = ws.t, ws.st, ws.t["caches"]
        tokens, sum_lp, step_t = t["tokens"], t["sum_lp"], t["step_t"]
        eot_only, own_slot, row0 = t["eot_only"], t["own_slot"], t["row0"]
        anc = caches[0][4] if use_split else None
        pads = t["pads"] if pad_lens is not None else None

        def setup() -> None:
            cross = self._setup_cross(ws)
            for cache in caches:
                for c in cache:
                    c.zero_()
            pad_k = ws.into("pad_k", pads.repeat_interleave(K)) \
                if pads is not None else None
            if use_split:
                logits, _, _ = model.decoder(
                    t["prompt"], t["xa"], 0, [c[:2] for c in caches],
                    cross_kvs=cross, pad_lens=pads)
                ws.into("nsp", torch.softmax(logits[:, sot_pos],
                                             dim=-1)[:, tok.no_speech])
                ws.into("cur_logits",
                        logits[:, -1].repeat_interleave(K, dim=0))
            else:
                logits, _, _ = model.decoder(
                    t["prompt"].repeat_interleave(K, dim=0), t["xa"], 0,
                    caches, cross_kvs=cross, pad_lens=pad_k)
                ws.into("nsp", torch.softmax(logits[::K, sot_pos],
                                             dim=-1)[:, tok.no_speech])
                ws.into("cur_logits", logits[:, -1])
            tokens.fill_(self._eot)
            self._reset_state(st)
            sum_lp.copy_(t["sum_lp0"])
            step_t.zero_()

        def step(first: bool) -> None:
            cur_logits = t["cur_logits"]
            lg = self._filter(cur_logits, st, 0 if first else 1)
            lp = torch.log_softmax(lg, dim=-1)                  # [BK, V]
            # finished beams: only eot, contributing zero logprob
            lp = torch.where(st["finished"][:, None], eot_only[None, :], lp)
            cand = (sum_lp[:, None] + lp).reshape(B, K * V)
            top_lp, top_idx = torch.topk(cand, K, dim=-1)      # [B, K]
            src_beam = top_idx // V
            next_tok = (top_idx % V).reshape(BK)
            gather = (row0 + src_beam).reshape(BK)
            if use_split:
                # no cache gather: reordering is an ancestry update, and
                # the new token's K/V is written at the logical row itself
                anc.copy_(torch.gather(anc, 1, src_beam[..., None].expand(
                    B, K, anc.shape[2])))
                anc.index_copy_(2, step_t.reshape(1), own_slot)
            else:
                for ck, cv in caches:
                    ck.copy_(ck[gather])
                    cv.copy_(cv[gather])
            tokens.copy_(tokens[gather])
            tokens.index_copy_(1, step_t.reshape(1), next_tok[:, None])
            finished = st["finished"][gather]
            is_eot = (next_tok == self._eot) | finished
            new_finished = finished | (next_tok == self._eot)
            is_ts = (next_tok >= self._ts_begin) & ~new_finished
            new = dict(
                length=st["length"][gather] + (~is_eot).long(),
                finished=new_finished,
                prev_was_ts=is_ts,
                prev_prev_was_ts=st["prev_was_ts"][gather],
                last_ts=torch.where(is_ts, next_tok, st["last_ts"][gather]),
                any_ts=st["any_ts"][gather] | is_ts)
            for k, v in new.items():
                st[k].copy_(v)
            sum_lp.copy_(top_lp.reshape(BK))
            new_logits, _, _ = model.decoder(
                next_tok[:, None], t["xa"], pos0 + step_t, caches,
                cross_kvs=ws.cross, pad_lens=t.get("pad_k"))
            cur_logits.copy_(new_logits[:, 0])
            step_t.add_(1)

        self._run_call(ws, setup, step, max_new, graph, t_call, ())
        self._finish_call(ws, fresh, ())
        stats = torch.cat([sum_lp.reshape(B, K),
                           st["length"].reshape(B, K).float(),
                           t["nsp"][:, None]], dim=1)
        return tokens.reshape(B, K, max_new).clone(), stats

    # ------------------------------------------------------------------
    def decode(self, xa: torch.Tensor,
               prompt: Optional[Sequence[int]] = None) -> Dict:
        B = xa.shape[0]
        cap = max(self.opt.max_rows_per_dispatch // self.beam_size, 1)
        if B > cap:
            return self._concat_results([
                self.decode(xa[c0:c0 + cap], prompt)
                for c0 in range(0, B, cap)])
        with span("stage.decode.prepare"):
            initial = self._initial_tokens(prompt)
            prompt_tokens = torch.tensor(initial, dtype=torch.long,
                                         device=xa.device).repeat(B, 1)
        tokens, stats = self._beam_loop(xa, len(initial), prompt_tokens)
        return self._read_back_and_unpack(tokens, stats)

    def _unpack_beam(self, tokens: np.ndarray, stats: np.ndarray) -> Dict:
        B, K = tokens.shape[:2]
        sum_lp, length, nsp = stats[:, :K], stats[:, K:2 * K], stats[:, -1]
        # length-normalized ranking (whisper's MaximumLikelihoodRanker)
        avg = sum_lp / np.maximum(length + 1, 1)
        best = avg.argmax(axis=1)
        out_tokens: List[List[int]] = []
        for b in range(B):
            t = tokens[b, best[b]]
            end = int(np.argmax(t == self._eot)) if (t == self._eot).any() \
                else len(t)
            out_tokens.append(t[:end].tolist())
        return dict(tokens=out_tokens, avg_logprob=avg[np.arange(B), best],
                    no_speech_prob=nsp)

    def decode_prompted(self, xa: torch.Tensor,
                        prompts: Sequence[Optional[Sequence[int]]],
                        temperature: float = 0.0, generator=None,
                        generators=None) -> Dict:
        """Beam decode with a DIFFERENT prompt per row (see
        GreedyDecoder.decode_prompted). The sampling arguments exist for
        interface parity: beam search is the temperature-0 rung (the
        fallback ladder samples through the greedy decoder, as whisper
        does)."""
        if temperature != 0.0:
            raise ValueError("beam search is the temperature-0 rung")
        B = xa.shape[0]
        cap = max(self.opt.max_rows_per_dispatch // self.beam_size, 1)
        if B > cap:
            return self._concat_results([
                self.decode_prompted(xa[c0:c0 + cap],
                                     list(prompts)[c0:c0 + cap])
                for c0 in range(0, B, cap)])
        with span("stage.decode.prepare"):
            toks, pads, P_pad = self._pack_prompts(prompts)
            toks = torch.from_numpy(toks).to(xa.device)
            pads = torch.from_numpy(pads).to(xa.device)
        tokens, stats = self._beam_loop(xa, P_pad, toks, pad_lens=pads)
        return self._read_back_and_unpack(tokens, stats)

    def _read_back_and_unpack(self, tokens: torch.Tensor,
                              stats: torch.Tensor) -> Dict:
        with span("stage.decode.readback"):
            tokens, stats = tokens.cpu().numpy(), stats.cpu().numpy()
        with span("stage.decode.unpack"):
            return self._unpack_beam(tokens, stats)
