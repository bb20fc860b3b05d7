"""Batched beam-search decoding for Whisper (beam_size=5 in the shipped
config).

Port of notsofar_tpu/asr/beam.py. One Python loop over decode steps;
state is kept per (batch, beam): cumulative logprobs, finished latches,
per-beam timestamp-rule state, and the token buffer, which is reordered
with the same gather as the state (no host-side genealogy backtracking).

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
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from notsofar_tpu_torch.asr.decoding import (NEG_INF, DecodeOptions,
                                             GreedyDecoder)
from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
from notsofar_tpu_torch.models.whisper import WhisperModel


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
                   pad_lens: Optional[torch.Tensor] = None):
        """xa: [B, 1500, D]; prompt_tokens: [B, P]. pad_lens: optional [B]
        left-pad widths for per-row prompts (see GreedyDecoder). Returns
        (tokens [B, K, max_new], stats [B, 2K+1] = sum_lp || length ||
        no_speech_prob)."""
        model, tok = self.model, self.tok
        dev = xa.device
        K = self.beam_size
        B = xa.shape[0]
        BK = B * K
        V = model.dims.n_vocab
        d = model.dims
        use_split = (self.split_cache and d.n_text_state % 128 == 0
                     and d.n_text_state // d.n_text_head in (64, 128))
        max_new = min(self.opt.max_new_tokens, d.n_text_ctx - prompt_len)
        P = prompt_tokens.shape[1]
        cross_kvs = model.precompute_cross_kv(xa)
        sot_pos = self._sot_pos(prompt_len)
        pad_k = pad_lens.repeat_interleave(K) if pad_lens is not None \
            else None
        anc = None
        if use_split:
            # the prompt is identical across a stream's K beams: prefill at
            # batch B into the shared prompt segment
            G = -(-max_new // 64) * 64
            prompt_caches = self._zeros_caches(B, P)
            logits, prompt_caches, _ = model.decoder(
                prompt_tokens, xa, 0, prompt_caches, cross_kvs=cross_kvs,
                pad_lens=pad_lens)
            nsp = torch.softmax(logits[:, sot_pos], dim=-1)[:, tok.no_speech]
            cur_logits = logits[:, -1].repeat_interleave(K, dim=0)
            caches = self._zeros_caches(BK, G)
            anc = torch.zeros((B, K, G), dtype=torch.int32, device=dev)
        else:
            prompt_k = prompt_tokens.repeat_interleave(K, dim=0)
            caches = self._zeros_caches(
                BK, min(-(-(max_new + prompt_len) // 64) * 64, d.n_text_ctx))
            logits, caches, _ = model.decoder(
                prompt_k, xa, 0, caches, cross_kvs=cross_kvs, pad_lens=pad_k)
            nsp = torch.softmax(logits[::K, sot_pos],
                                dim=-1)[:, tok.no_speech]
            cur_logits = logits[:, -1]
            prompt_caches = None

        st = self._init_state(BK)
        tokens = torch.full((BK, max_new), self._eot, dtype=torch.long,
                            device=dev)
        sum_lp = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                             NEG_INF).repeat(B)
        eot_only = torch.full((V,), NEG_INF, device=dev)
        eot_only[self._eot] = 0.0
        beam_ids = torch.arange(K, dtype=torch.int32, device=dev)
        row0 = torch.arange(B, device=dev)[:, None] * K
        step = 0
        while step < max_new and not bool(st["finished"].all()):
            lg = self._filter(cur_logits, st, step)
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
                anc = torch.gather(anc, 1, src_beam[..., None].expand(
                    B, K, anc.shape[2])).contiguous()
                anc[:, :, step] = beam_ids
            else:
                caches = [(ck[gather], cv[gather]) for ck, cv in caches]
            tokens = tokens[gather]
            tokens[:, step] = next_tok
            finished = st["finished"][gather]
            is_eot = (next_tok == self._eot) | finished
            new_finished = finished | (next_tok == self._eot)
            is_ts = (next_tok >= self._ts_begin) & ~new_finished
            st = dict(
                length=st["length"][gather] + (~is_eot).long(),
                finished=new_finished,
                prev_was_ts=is_ts,
                prev_prev_was_ts=st["prev_was_ts"][gather],
                last_ts=torch.where(is_ts, next_tok, st["last_ts"][gather]),
                any_ts=st["any_ts"][gather] | is_ts)
            sum_lp = top_lp.reshape(BK)
            if use_split:
                split = [(kp, vp, kg, vg, anc) for (kp, vp), (kg, vg)
                         in zip(prompt_caches, caches)]
                new_logits, _, _ = model.decoder(
                    next_tok[:, None], xa, P + step, split,
                    cross_kvs=cross_kvs, pad_lens=pad_k)
            else:
                new_logits, caches, _ = model.decoder(
                    next_tok[:, None], xa, prompt_len + step, caches,
                    cross_kvs=cross_kvs, pad_lens=pad_k)
            cur_logits = new_logits[:, 0]
            step += 1
        stats = torch.cat([sum_lp.reshape(B, K),
                           st["length"].reshape(B, K).float(),
                           nsp[:, None]], dim=1)
        return tokens.reshape(B, K, max_new), stats

    # ------------------------------------------------------------------
    def decode(self, xa: torch.Tensor,
               prompt: Optional[Sequence[int]] = None) -> Dict:
        B = xa.shape[0]
        cap = max(self.opt.max_rows_per_dispatch // self.beam_size, 1)
        if B > cap:
            return self._concat_results([
                self.decode(xa[c0:c0 + cap], prompt)
                for c0 in range(0, B, cap)])
        initial = self._initial_tokens(prompt)
        prompt_tokens = torch.tensor(initial, dtype=torch.long,
                                     device=xa.device).repeat(B, 1)
        tokens, stats = self._beam_loop(xa, len(initial), prompt_tokens)
        return self._unpack_beam(tokens.cpu().numpy(), stats.cpu().numpy())

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
        toks, pads, P_pad = self._pack_prompts(prompts)
        dev = xa.device
        tokens, stats = self._beam_loop(
            xa, P_pad, torch.from_numpy(toks).to(dev),
            pad_lens=torch.from_numpy(pads).to(dev))
        return self._unpack_beam(tokens.cpu().numpy(), stats.cpu().numpy())
