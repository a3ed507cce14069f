#!/usr/bin/env python3
"""Refit the BCSR builder's H100 cost model from the points
``chip_smoke.py``'s phase 23 prints.

    python3 chip_smoke.py > smoke.log      # on the card
    python3 tools/fit_kernel_costs.py smoke.log

The log's ``cost-shape`` lines give each operator half's kept tiles and
remainder edges a row block, its ``cost-point`` lines the fused kernel's
warm and cold ms on it at one width and tile dtype (``held_out`` marks the
operators of the model paths, which the fit does not see), and its
``gather-point`` lines the warm ms of one permutation gather (its
``hub-point`` lines, a row of 20,000 edges, are not read: the model prices
row blocks and their tasks, not rows).  The fit is
that of ``ops/bcsr.py``'s makespan model (``KernelCosts``): per tile dtype,
(launch, a0, a1, b0, b1, r0, r1) in ns with every constant at least 0,
minimizing the squared relative error of the warm prediction over the
sweep's points.  The prediction is the most loaded CTA's sum, so the fit
alternates: take each point's most loaded CTA under the current constants
and the points the byte floor does not bind, solve the non-negative least
squares on them, again until the CTAs stop changing.  The gathers fit
``g0 + rows · row_ns + bytes / bw`` the same way.  Prints the
constants in the form ``ops/bcsr.py`` holds them, each point's prediction
and relative error, and the median absolute relative error over the sweep
and over the held-out points.  Needs numpy and scipy; no card.
"""

import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pytorch_geometric_temporal_tpu_torch.ops import bcsr  # noqa: E402

PARAMS = ("launch", "a0", "a1", "b0", "b1", "r0", "r1")
START = (3000.0, 300.0, 3.0, 300.0, 10.0, 500.0, 0.05)


def read_points(lines):
    """(shapes {label: (tiles, rems)}, cost points, gather points) from the
    lines of a ``chip_smoke.py`` log."""
    shapes, points, gathers = {}, [], []
    for line in lines:
        line = line.strip()
        for tag, sink in (("cost-shape ", None), ("cost-point ", points),
                          ("gather-point ", gathers)):
            if line.startswith(tag):
                rec = json.loads(line[len(tag):])
                if sink is None:
                    shapes[rec["label"]] = (np.asarray(rec["tiles"]),
                                            np.asarray(rec["rems"]))
                else:
                    sink.append(rec)
    return shapes, points, gathers


def cta_features(tiles, rems, f, bf16, costs=bcsr.H100):
    """(sms, 7) per-CTA sums the prediction is linear in, from the kernel's
    loop over its item list (``bcsr.cta_loads``): [1, items, items·FT, tile
    chunks, tile chunks·FT, remainder stages, stages·RE·FT]."""
    n, t, s, ft, re = bcsr.cta_loads(tiles[None], rems[None], f, bf16,
                                     costs.sms)
    n, t, s = n[0], t[0], s[0]
    return np.stack([np.ones_like(n), n, n * ft, t, t * ft, s, s * re * ft],
                    1)


def floor_ns(tiles, rems, f, bf16, costs=bcsr.H100):
    n_bytes = float(bcsr.half_bytes(tiles, rems, f, bf16)[0])
    return n_bytes / costs.bytes_per_ns


def predict_ns(p, phi, floor):
    return max(float((phi @ p).max()), floor)


def fit_dtype(recs, max_iter=30):
    """NNLS of the makespan constants on ``recs`` (each with ``phi``,
    ``floor``, ``y`` ns), alternating over each point's most loaded CTA."""
    from scipy.optimize import nnls

    p = np.asarray(START)
    picked = None
    for _ in range(max_iter):
        rows, ys, now = [], [], []
        for r in recs:
            c = int(np.argmax(r["phi"] @ p))
            now.append(c)
            if float(r["phi"][c] @ p) >= r["floor"]:
                rows.append(r["phi"][c] / r["y"])
                ys.append(1.0)
        if now == picked:
            break
        picked = now
        p, _ = nnls(np.asarray(rows), np.asarray(ys))
    return p


def fit_gathers(gathers):
    """(g0 ns, ns a row, bytes a ns) of ``g0 + rows · row_ns + bytes / bw``,
    non-negative least squares on relative error."""
    from scipy.optimize import nnls

    y = np.asarray([g["warm_ms"] * 1e6 for g in gathers])
    a = np.asarray([[1.0, g["n_pad"], 2.0 * g["n_pad"] * g["f"] * g["bytes"]]
                    for g in gathers]) / y[:, None]
    (g0, row_ns, per_byte), _ = nnls(a, np.ones_like(y))
    return float(g0), float(row_ns), float(1.0 / per_byte)


def evaluate(shapes, points, constants):
    """Each point with ``pred_ms`` and ``rel`` (prediction over measured,
    minus one) under ``constants`` {dtype: 7-tuple}."""
    out = []
    for pt in points:
        tiles, rems = shapes[pt["shape"]]
        bf16 = pt["dtype"] == "bf16"
        phi = cta_features(tiles, rems, pt["f"], bf16)
        pred = predict_ns(np.asarray(constants[pt["dtype"]]), phi,
                          floor_ns(tiles, rems, pt["f"], bf16)) / 1e6
        out.append(dict(pt, pred_ms=pred, rel=pred / pt["warm_ms"] - 1.0))
    return out


def median_abs(rows):
    return statistics.median(abs(r["rel"]) for r in rows) if rows else 0.0


def fit(shapes, points, gathers):
    """{"bf16": 7-tuple, "f32": 7-tuple, "gather": (g0, row_ns, bw)} fitted
    on the points that are not held out."""
    constants = {}
    for dt in ("bf16", "f32"):
        recs = []
        for pt in points:
            if pt["dtype"] != dt or pt.get("held_out"):
                continue
            tiles, rems = shapes[pt["shape"]]
            recs.append(dict(
                phi=cta_features(tiles, rems, pt["f"], dt == "bf16"),
                floor=floor_ns(tiles, rems, pt["f"], dt == "bf16"),
                y=pt["warm_ms"] * 1e6))
        constants[dt] = tuple(float(v) for v in fit_dtype(recs))
    if gathers:
        constants["gather"] = fit_gathers(gathers)
    return constants


def evaluate_gathers(gathers, constants):
    """Each gather point with ``pred_ms`` and ``rel`` under
    ``constants["gather"]``."""
    out = []
    for g in gathers:
        pred = bcsr.gather_ns(constants["gather"], g["n_pad"], g["f"],
                              g["bytes"]) / 1e6
        out.append(dict(g, pred_ms=pred, rel=pred / g["warm_ms"] - 1.0))
    return out


def report(shapes, points, gathers, constants, title, log=print):
    """Log ``constants``, each point's prediction and the medians; returns
    (median |rel| over the sweep, over the held-out points, over all
    kernel points, over the gathers)."""
    log(f"{title}:")
    for dt in ("bf16", "f32"):
        log(f"  {dt}: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                    zip(PARAMS, constants[dt])))
    if "gather" in constants:
        g0, row_ns, bw = constants["gather"]
        log(f"  gather: g0 {g0:.4g} ns, {row_ns:.4g} ns a row, {bw:.4g} bytes "
            f"a ns")
    rows = evaluate(shapes, points, constants)
    for r in rows:
        log(f"  {r['shape']} {r['dtype']} F={r['f']}"
            f"{' (held out)' if r.get('held_out') else ''}: warm "
            f"{r['warm_ms']:.4f} ms, predicted {r['pred_ms']:.4f} ms, "
            f"{r['rel'] * 100:+.1f}%")
    grows = (evaluate_gathers(gathers, constants)
             if "gather" in constants else [])
    for g in grows:
        log(f"  gather n_pad={g['n_pad']} F={g['f']} {g['bytes']} B: "
            f"warm {g['warm_ms']:.4f} ms, predicted {g['pred_ms']:.4f} ms, "
            f"{g['rel'] * 100:+.1f}%")
    sweep = [r for r in rows if not r.get("held_out")]
    held = [r for r in rows if r.get("held_out")]
    med = (median_abs(sweep), median_abs(held), median_abs(rows),
           median_abs(grows))
    off = ([f"{r['shape']} {r['dtype']} F={r['f']}"
            for r in rows if abs(r["rel"]) > 0.5]
           + [f"gather n_pad={g['n_pad']} F={g['f']} {g['bytes']} B"
              for g in grows if abs(g["rel"]) > 0.5])
    log(f"  median |relative error| of the warm prediction: sweep "
        f"{med[0] * 100:.1f}% ({len(sweep)} points), held out "
        f"{med[1] * 100:.1f}% ({len(held)}), all {med[2] * 100:.1f}%; "
        f"gathers {med[3] * 100:.1f}% ({len(grows)}, largest "
        f"{max((abs(g['rel']) for g in grows), default=0.0) * 100:.1f}%); "
        f"off by more than 50%: " + (", ".join(off) or "none"))
    return med


def committed():
    """The constants ``ops/bcsr.py`` holds, in the fit's form."""
    return {"bf16": bcsr.H100.bf16, "f32": bcsr.H100.f32,
            "gather": bcsr.H100.gather}


def main(argv):
    if len(argv) != 2:
        raise SystemExit("usage: fit_kernel_costs.py LOG")
    shapes, points, gathers = read_points(
        Path(argv[1]).read_text().splitlines())
    if not points:
        raise SystemExit(f"no cost-point lines in {argv[1]}")
    report(shapes, points, gathers, committed(),
           "the constants in ops/bcsr.py (H100)")
    constants = fit(shapes, points, gathers)
    report(shapes, points, gathers, constants, "refit on this log's sweep")
    print("H100 = KernelCosts(\n    \"h100\", sms=132, bytes_per_ns=3350.0,")
    for dt in ("bf16", "f32"):
        print(f"    {dt}=(" + ", ".join(f"{v:.4g}" for v in constants[dt])
              + "),")
    if "gather" in constants:
        print("    gather=(" + ", ".join(f"{v:.4g}" for v in
                                         constants["gather"]) + "),")
    print(")")


if __name__ == "__main__":
    main(sys.argv)
