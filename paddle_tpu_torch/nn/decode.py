"""Beam-search decoding, the counterpart of ``paddle_tpu/nn/decode.py``:
``BeamSearchDecoder`` (with ``tile_beam_merge_with_batch``) and
``dynamic_decode``.

The loop runs on the host, one decoder step a call, and stops when a
host read of ``finished.all()`` says every beam has ended (JAX's does
the same).  Layout is batch-major, ``[batch, beam, ...]``; the result
is ``[batch, time, beam]`` through ``gather_tree`` unless
``output_time_major``.  A step is JAX's term for term: log-softmax of
the cell's output in f32; a finished beam extends only with
``end_token`` (at 0, every other token at -1e9); the beam's total
log-probability plus the step's, then ``lax.top_k``'s choice over
``beam * vocab`` candidates per source, the lower flat index first
among equal totals (:func:`paddle_tpu_torch.tensor.topk`, stable on the
card too); parents ``idx // vocab``, tokens ``idx % vocab``, and the
cell's states gathered by parent.  ``dynamic_decode`` counts a beam's
length as JAX's: one for every step after which it is not finished,
kept by beam position (not reordered by parent).  The cell's states
must be a tensor or a flat tuple of tensors, each ``[batch, ...]``.
"""

from __future__ import annotations

import torch

from ..tensor.search import topk
from .functional_common import gather_tree

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


class BeamSearchDecoder:
    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[batch, ...] -> [batch * beam, ...]``, each row repeated
        ``beam_size`` times in place."""
        return x[:, None].expand(x.shape[0], beam_size,
                                 *x.shape[1:]).reshape(-1, *x.shape[1:])

    def _merge(self, a):
        return a.reshape(-1, *a.shape[2:])

    def _split(self, a, batch):
        return a.reshape(batch, self.beam_size, *a.shape[1:])

    def initialize(self, initial_cell_states):
        """``(inputs, (cell_states, log_probs, finished), batch)``: the
        states tiled over the beams, every beam at ``start_token``, the
        first at log-probability 0 and the others at -1e9."""
        states = initial_cell_states
        nested = isinstance(states, (tuple, list))
        leaves = states if nested else (states,)
        batch = int(leaves[0].shape[0])
        tiled = [self.tile_beam_merge_with_batch(s, self.beam_size)
                 for s in leaves]
        cell_states = tuple(tiled) if nested else tiled[0]
        dev = leaves[0].device
        ids = torch.full((batch, self.beam_size), self.start_token,
                         dtype=torch.int32, device=dev)
        first = torch.arange(self.beam_size, device=dev)[None, :] == 0
        log_probs = torch.where(first, 0.0, -1e9) * torch.ones(
            (batch, 1), device=dev)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return (self._embed(ids.reshape(-1)),
                (cell_states, log_probs, finished), batch)

    def _embed(self, flat_ids):
        if self.embedding_fn is not None:
            return self.embedding_fn(flat_ids)
        return flat_ids

    def step(self, time, inputs, states, batch):
        """``(token, parent, log_probs, next_inputs, next_states,
        finished)``, each ``[batch, beam]`` but the inputs and states."""
        cell_states, log_probs, finished = states
        out = self.cell(inputs, cell_states)
        cell_out, new_cell_states = (out if isinstance(out, tuple)
                                     and len(out) == 2
                                     else (out, cell_states))
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        vocab = cell_out.shape[-1]
        step_lp = torch.log_softmax(cell_out.float(), dim=-1)
        step_lp = self._split(step_lp, batch)
        fin_mask = torch.full((vocab,), -1e9, device=step_lp.device)
        fin_mask[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], fin_mask, step_lp)
        total = log_probs[..., None] + step_lp
        top_lp, top_idx = topk(total.reshape(batch, -1), self.beam_size)
        parent = torch.div(top_idx, vocab, rounding_mode="floor")
        token = top_idx - parent * vocab

        def reorder(leaf):
            a = self._split(leaf, batch)
            idx = parent.long().reshape(parent.shape + (1,) * (a.dim() - 2))
            return self._merge(torch.gather(a, 1, idx.expand(
                -1, -1, *a.shape[2:])))

        if isinstance(new_cell_states, (tuple, list)):
            new_cell_states = tuple(reorder(s) for s in new_cell_states)
        else:
            new_cell_states = reorder(new_cell_states)
        new_finished = (torch.gather(finished, 1, parent.long())
                        | (token == self.end_token))
        next_inputs = self._embed(token.reshape(-1))
        return (token, parent, top_lp, next_inputs,
                (new_cell_states, top_lp, new_finished), new_finished)


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam is finished or ``max_step_num``
    steps: ``(ids, final_cell_states)``, and the lengths with
    ``return_length``.  ``impute_finished`` and ``is_test`` are
    ignored, as JAX's."""
    with torch.no_grad():
        inputs, states, batch = decoder.initialize(inits)
        finished = states[2]
        seq_len = torch.zeros(finished.shape, dtype=torch.int32,
                              device=finished.device)
        tokens, parents = [], []
        for t in range(int(max_step_num)):
            token, parent, _, inputs, states, finished = decoder.step(
                t, inputs, states, batch)
            tokens.append(token)
            parents.append(parent)
            seq_len = seq_len + (~finished).to(torch.int32)
            if bool(finished.all()):
                break
        ids = gather_tree(torch.stack(tokens), torch.stack(parents))
        if not output_time_major:
            ids = ids.permute(1, 0, 2)
        if return_length:
            return ids, states[0], seq_len
        return ids, states[0]
