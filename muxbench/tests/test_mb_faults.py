"""A run with the timed path broken underneath must come out not
correct.  The harness's look for a card is skipped and the rest of a
run is driven at reduced width on the CPU, once for each fault a
serving cell can have:

* a step that returns its state unchanged: the KV writes dropped (the
  attention models), the SSM state never written back (Mamba2);
* half of the batch left out: the second half of a step's rows answered
  with the first half's logits;
* a token altered where it is produced: one served token in seven
  moved off the argmax.

A cell runs on one card, so there is no exchange between chips to
leave out.  The sound run and the broken ones are held to the same
limit, the reduced float32 size's (``cells.limited``): the cells' own
limits are set for bfloat16 at published widths, where logits spread
wider than at reduced width."""
from __future__ import annotations

import numpy as np
import pytest

from muxbench import harness, run
from muxbench.tests.cells import limited

CELLS = ["pair-chat", "dense-ssm-chat", "pair-longprompt"]


def _greedy(patch):
    harness.port()
    from repro_torch.serving import engine, mux
    greedy = engine.greedy_tokens

    def broken(logits):
        return patch(logits, greedy)
    return [(engine, "greedy_tokens", broken), (mux, "greedy_tokens", broken)]


def state_unchanged():
    harness.port()
    from repro_torch.serving import cache_ops, engine
    return [(cache_ops, "write_slots", lambda *a, **k: None),
            (engine, "_put_rows", lambda *a, **k: None)]


def half_batch():
    def patch(logits, greedy):
        flat = logits.reshape(-1, logits.shape[-1]).clone()
        n = flat.shape[0]
        if n >= 2:
            flat[n - n // 2:] = flat[:n // 2]
        return greedy(flat.reshape(logits.shape))
    return _greedy(patch)


def token_altered():
    calls = [0]

    def patch(logits, greedy):
        out = np.array(greedy(logits))
        calls[0] += 1
        if calls[0] % 7 == 0:
            flat = out.reshape(-1)
            flat[0] = (flat[0] + 1) % logits.shape[-1]
        return out
    return _greedy(patch)


FAULTS = {"state unchanged": state_unchanged, "half the batch": half_batch,
          "token altered": token_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = limited(name)
    sound = run.run_cell(cell, 41, 2.0, False, device="cpu")
    assert sound["correct"], sound["checks"]
    for mod, attr, fn in FAULTS[fault]():
        monkeypatch.setattr(mod, attr, fn)
    out = run.run_cell(cell, 41, 2.0, False, device="cpu")
    assert not out["correct"], out["checks"]
