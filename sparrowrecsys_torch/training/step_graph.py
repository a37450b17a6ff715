"""The training step as one CUDA graph, captured once and replayed.

On the card an eager step launches each of its operations from Python,
through autograd and `torch.func.functional_call`; where the kernels are
small (DIN at SparrowRecSys's widths: about 244 operations a step, each
some 25 us of device work) the host's launches set the pace. A
`StepGraph` captures one whole step of `Trainer._train_step`, the forward
through the hand-written kernels, `torch.autograd.grad`, the grouped Adam
and the metric update, and replays it: the same kernels in the same
order, launched by the card. A replay runs no Python, so a kernel's
`launches` counter (`ops/kernels.py`) counts the capture and not the
replays.

A graph reads and writes the addresses it was captured on, so it holds:
- the batch in buffers of its own, which `replay` fills from each step's
  columns, labels and mask (`fits`: their keys, shapes and dtypes are the
  captured ones);
- the params it was captured on, updated in place as the eager step
  updates them;
- the optimizer and metric states it was captured on: the graph computes
  the step's new states and, last, copies them into those tensors, which
  `replay` returns. A metric state other than the graph's (`Trainer.fit`
  starts one each epoch) is copied in before the replay.

`Trainer._train_step` decides which steps take the graph.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state (a tensor, or dicts, lists and tuples of them,
    nested; None skipped), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in leaves(x)]
    return []


def _copy(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """`d.copy_(s)` for each pair, in one `_foreach_copy_` a dtype: it
    takes its multi-tensor path, a launch or two for the whole list, only
    where every tensor of the list has one dtype, and else copies tensor
    by tensor."""
    groups: Dict[torch.dtype, tuple] = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _like(x: Optional[torch.Tensor], y: Optional[torch.Tensor]) -> bool:
    if x is None or y is None:
        return x is y
    return x.shape == y.shape and x.dtype == y.dtype


class StepGraph:
    """One captured step and the tensors it reads and writes."""

    def __init__(self, step: Callable, params: Dict[str, torch.Tensor], opt_state, mstate,
                 feats: Dict[str, torch.Tensor], labels: torch.Tensor,
                 mask: Optional[torch.Tensor], stream: torch.cuda.Stream):
        """Capture `step(params, opt_state, mstate, feats, labels, mask) ->
        (params, opt_state, mstate)` on `stream`, on buffers of the batch's
        keys, shapes and dtypes. Nothing runs until `replay`."""
        self.params, self.opt_state, self.mstate = params, opt_state, mstate
        self._params = dict(params)
        self._opt = leaves(opt_state)
        self._states = self._opt + leaves(mstate)
        self.feats = {k: torch.empty_like(v) for k, v in feats.items()}
        self.labels = torch.empty_like(labels)
        self.mask = None if mask is None else torch.empty_like(mask)
        # `step` (a Trainer's bound method) is not kept: a graph that held
        # its trainer would keep both, and the graph's memory pool, alive
        # until the cycle collector ran.
        self.graph = self._capture(step, stream)

    def _capture(self, step: Callable, stream: torch.cuda.Stream):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            self._body(step)
        return graph

    def _body(self, step: Callable) -> None:
        """The step on the graph's buffers and states, its new states
        copied into the graph's."""
        _, opt_state, mstate = step(self.params, self.opt_state, self.mstate, self.feats,
                                    self.labels, self.mask)
        self._write(opt_state, mstate)

    def holds(self, params: Dict[str, torch.Tensor], opt_state) -> bool:
        """Whether `params` and `opt_state` are the tensors the graph was
        captured on."""
        opt = leaves(opt_state)
        return (len(params) == len(self._params) and len(opt) == len(self._opt)
                and all(self._params.get(k) is v for k, v in params.items())
                and all(a is b for a, b in zip(opt, self._opt)))

    def fits(self, feats: Dict[str, torch.Tensor], labels: torch.Tensor,
             mask: Optional[torch.Tensor]) -> bool:
        """Whether a batch has the captured keys, shapes and dtypes."""
        return (feats.keys() == self.feats.keys()
                and all(_like(v, self.feats[k]) for k, v in feats.items())
                and _like(labels, self.labels) and _like(mask, self.mask))

    def replay(self, feats: Dict[str, torch.Tensor], labels: torch.Tensor,
               mask: Optional[torch.Tensor], mstate):
        """The captured step on this batch, from `mstate` (copied in unless
        it is the graph's); returns (params, opt_state, mstate), the
        graph's own tensors."""
        dst = [*self.feats.values(), self.labels]
        src = [*(feats[k] for k in self.feats), labels]
        if mask is not None:
            dst.append(self.mask)
            src.append(mask)
        if mstate is not self.mstate:
            dst += leaves(self.mstate)
            src += leaves(mstate)
        _copy(dst, src)
        self.graph.replay()
        return self.params, self.opt_state, self.mstate

    def keep(self, params: Dict[str, torch.Tensor], opt_state, mstate):
        """An eager step's result on the graph's params and optimizer state,
        its new states copied into the graph's tensors, so that the graph
        still holds them; returns (params, opt_state, mstate) as `replay`
        does."""
        self._write(opt_state, mstate)
        return params, self.opt_state, self.mstate

    def _write(self, opt_state, mstate) -> None:
        _copy(self._states, leaves(opt_state) + leaves(mstate))
