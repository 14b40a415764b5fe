"""Each fault a cell can have, planted under the timed path, turns the
run's ``correct`` false (the harness's look for a card skipped: the
small CPU cells of ``benchcells``).

MD (on canonised graphs, the path ``run_md_jit`` takes today): a step
that returns its state unchanged; half of the atoms' forces left out;
the energies altered where the chunk returns them.  Training: a step
that leaves the parameters unchanged; half of each batch left out of the
loss, the mean taken over the rest; the loss altered where the step
returns it; a compiled step fed a stale batch (``StepLoop.load_batch``
copies nothing; on the CPU the compiled step runs eagerly over the same
static batches, on the card see ``test_bench_control.py``).  (One card a
cell: there is no exchange between cards to leave out.)
"""

import dataclasses

import pytest
import torch

from benchcells import run_small


def md_state_unchanged(mp):
    from alignn_tpu_torch.ff import md_jit

    mp.setattr(md_jit.MDChunk, "_step", lambda self: self.k.add_(1))


def md_half_forces(mp):
    from alignn_tpu_torch.ff import md_jit

    original = md_jit.energy_and_forces

    def half(model, batch, frac):
        e, f, out = original(model, batch, frac)
        keep = torch.ones_like(f)
        keep[1::2] = 0.0       # every other atom: half of the real ones
        return e, f * keep, out

    mp.setattr(md_jit, "energy_and_forces", half)


def md_energy_altered(mp):
    from alignn_tpu_torch.ff import md_jit

    original = md_jit.MDChunk.run

    def run(self, *a, **kw):
        frac, vel, epots, ekins = original(self, *a, **kw)
        n = self.batch.node_mask.sum().item()
        return frac, vel, epots + 1e-3 * n, ekins     # 1 meV/atom

    mp.setattr(md_jit.MDChunk, "run", run)


def train_state_unchanged(mp):
    mp.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def train_half_batch(mp):
    from alignn_tpu_torch.train import state

    original = state._forward_and_loss

    def half(model, batch, *a, **kw):
        g = batch.graph_mask.shape[0]
        gm = batch.graph_mask.clone()
        gm[(g - 1) // 2:] = 0.0
        nm = batch.node_mask * gm[batch.node_graph]
        return original(model, dataclasses.replace(
            batch, graph_mask=gm, node_mask=nm), *a, **kw)

    mp.setattr(state, "_forward_and_loss", half)


def train_loss_altered(mp):
    from alignn_tpu_torch.train import state

    original = state._forward_and_loss

    def altered(*a, **kw):
        losses, res = original(*a, **kw)
        return {**losses, "loss": losses["loss"] * 1.01}, res

    mp.setattr(state, "_forward_and_loss", altered)


def train_stale_batch(mp):
    from alignn_tpu_torch.ff.step_loop import StepLoop

    mp.setattr(StepLoop, "load_batch", lambda self, batch: None)


MD = [md_state_unchanged, md_half_forces, md_energy_altered]
TRAIN = [train_state_unchanged, train_half_batch, train_loss_altered,
         train_stale_batch]
CASES = [("ff_md_si512", f) for f in MD] + \
    [(c, f) for c in ("ff_train_si64", "prop_train_jarvis") for f in TRAIN]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, _outcome = run_small(cell)
    assert result["correct"] is False, result["checks"]
