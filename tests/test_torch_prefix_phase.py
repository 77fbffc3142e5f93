"""``chip_smoke.py``'s prefix-cache phase rehearsed on the CPU at reduced
width (``serve_prefix(torch, device="cpu", reduced=True)``): its host
logic — the hit accounting against the trace's ceiling, the computed
prompt tokens against the adopted ones, the off-grid chunk offsets and
kernel 2's plain-version check at the first of them, the served
cached-vs-uncached first-token logits and their planted-fault control,
the copy-on-write round trip and
the small-arena run whose LRU reclaim must fire under the sanitizer —
runs here as it runs on the card, apart from the launch counts (the
wrappers launch nothing on CPU tensors)."""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


def test_prefix_phase_rehearses_on_cpu():
    res = chip_smoke.serve_prefix(torch, device="cpu", reduced=True)
    runs = res["runs"]
    assert set(runs) == {"(a) cache off", "(b) cache on",
                         "(c) cache on, small arena"}
    for run in runs.values():
        assert run["finished"] == run["requests"] == res["trace"]["requests"]
    assert res["hits"] >= chip_smoke.PREFIX_HIT_FLOOR * res["ceiling"] \
        * res["lookups"] > 0
    computed = res["prompt_tokens_computed"]
    assert computed["b"] == computed["a"] - res["hit_tokens"]
    assert res["off_64_offsets"] and all(o % 64 for o in res["off_64_offsets"])
    lc = res["logit_check"]
    assert lc["prompts"] == 8 and all(t > 0 for t in lc["adopted_tokens"])
    assert lc["max_rel_err"] < lc["tolerance"] and len(lc["per_prompt"]) == 8
    fault = res["planted_fault"]
    assert fault["prompts"] == 8 and fault["max_rel_err"] >= fault["floor"]
    k2 = res["kernel_2_at_served_offsets"]
    assert any(o % 64 for o in k2["q_offsets"])
    assert k2["max_abs_err"] <= k2["tolerance"]
    assert res["cow"]["pages_equal"] and res["cow"]["sole_holder_in_place"]
    assert res["evicted"] > 0 and res["index_blocks_after_drain"] > 0
    assert res["sanitizer_checks"] == runs["(c) cache on, small arena"][
        "ticks"] + 1
    # the report's prefix section reads each unit's pool: off → empty
    assert runs["(a) cache off"]["prefix"] == {}
    assert sum(p["evicted"] for p in runs["(c) cache on, small arena"][
        "prefix"].values()) == res["evicted"]
