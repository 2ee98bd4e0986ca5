"""utils/trace_tools' readers of recorded spans against device
activities, on hand-made spans and events with known answers:
generate_calls groups a thread's spans into calls, decode_report reads
the prefill, the decode steps (each call's last left out), their idle
share, operations a step, the gaps between spans and the clocks'
agreement, and idle_by_span names each idle gap by the innermost span
open at its midpoint, and by the parent once a child has ended."""

from video_llava_tpu_torch.utils.trace_tools import (
    Span,
    decode_report,
    generate_calls,
    idle_by_span,
)

US = 1000


def sp(name, s, e, id, parent=None):
    return Span(name, s * US, e * US, id, parent)


def acts(*pairs):
    """Device activities from (name, start us, end us)."""
    return [(n, s * US, e * US) for n, s, e in pairs]


def test_decode_report_by_hand():
    # two calls under parents 1 and 2, each a prefill and three steps;
    # a stray step with no prefill under parent 9 is no call's
    spans = [sp("outer", 0, 1000, 1), sp("outer", 1000, 2000, 2),
             sp("generate.prefill", 10, 110, 10, 1),
             sp("generate.decode_step", 110, 160, 11, 1),
             sp("generate.decode_step", 160, 220, 12, 1),
             sp("generate.decode_step", 220, 260, 13, 1),
             sp("generate.prefill", 1010, 1210, 20, 2),
             sp("generate.decode_step", 1212, 1262, 21, 2),
             sp("generate.decode_step", 1262, 1312, 22, 2),
             sp("generate.decode_step", 1312, 1350, 23, 2),
             sp("generate.decode_step", 5000, 5050, 99, 9)]
    calls = generate_calls(spans)
    assert [[s.id for s in c] for c in calls] == [[10, 11, 12, 13],
                                                  [20, 21, 22, 23]]
    ev = acts(("copy", 5, 8),           # before the first call's prefill
          ("k", 20, 100),           # prefill
          ("k", 100, 115),          # prefill, runs past its end
          ("k", 120, 130), ("k", 140, 150),  # step 11: 20 busy of 50
          ("k", 170, 200),          # step 12: 30 busy of 60
          ("k", 230, 290),          # last step, runs past its end
          ("k", 1020, 1200),
          ("k", 1212, 1237), ("k", 1230, 1240),  # step 21: 28 of 50
          ("k", 1270, 1280),        # step 22: 10 of 50
          ("k", 1320, 1360))
    r = decode_report(calls, ev, windows=[(0, 300 * US),
                                          (1000 * US, 1400 * US)])
    assert abs(r["prefill_ms"] - 0.15) < 1e-12
    assert r["steps"] == 4
    assert abs(r["decode_step_ms"] - (50 + 60 + 50 + 50) / 4 / 1000) < 1e-12
    busy = 25 + 30 + 28 + 10  # step 11 holds 5 of the prefill's tail
    assert abs(r["decode_idle_share"]
               - 100 * (1 - busy / 210)) < 1e-9
    assert r["decode_ops_per_step"] == (2 + 1 + 2 + 1) / 4
    assert r["max_gap_us"] == 2.0
    # 12 activities start in the windows; the copy before the prefill
    # and the prefill's kernel that runs past its end are outside
    assert r["activities"] == 12
    assert abs(r["inside_share"] - 10 / 12) < 1e-12
    # without windows each call's own extent is read
    r2 = decode_report(calls, ev)
    assert r2["activities"] == 11
    assert abs(r2["inside_share"] - 10 / 11) < 1e-12
    empty = decode_report([], ev)
    assert empty["prefill_ms"] is None and empty["decode_step_ms"] is None
    assert empty["inside_share"] is None and empty["max_gap_us"] is None


def test_idle_by_span_innermost_then_parent():
    spans = [sp("harness", 0, 100, 1),
             sp("child", 10, 40, 2, 1),
             sp("grandchild", 20, 30, 3, 2),
             sp("late", 60, 70, 4, 1)]
    ev = acts(("k", 0, 12), ("k", 14, 22), ("k", 26, 34), ("k", 38, 50),
              ("k", 55, 61), ("k", 63, 80))
    idle = idle_by_span(ev, spans, 0, 120 * US)
    # gaps: 12-14 child, 22-26 grandchild, 34-38 child (after the
    # grandchild ended), 50-55 harness (after the child ended), 61-63
    # late, 80-120 mid 100: harness has ended at 100 -> none
    want = {"child": (6, 2, 4), "grandchild": (4, 1, 4),
            "harness": (5, 1, 5), "late": (2, 1, 2), "none": (40, 1, 40)}
    assert set(idle) == set(want)
    for name, (us, n, longest) in want.items():
        got = idle[name]
        assert abs(got[0] - us * 1e-6) < 1e-12 and got[1] == n
        assert abs(got[2] - longest * 1e-6) < 1e-12
