"""Fingerprints of every tile kernel's outputs on fixed inputs, to compare two
trees bit for bit on one CUDA card.

Runs B1 and B2 (H = 128 and 40) and every GAT tile kernel (B3-B9, B4, B5s,
B6s; 8x8, 1x40 and 8x128) on the flagship's tiles (ogbn-arxiv scale, the
``--clustered`` hybrid layout) with inputs drawn from a seeded generator on
the card, each kernel twice, and prints one JSON object: for each kernel and
shape the SHA-256 of its outputs' bytes in each launch (``bits``) and the
outputs' shapes (``shapes``). The backward kernels take the plain forward's
``m``. B2, B4, B5s and B6s add with atomics, so their bits are not expected
to repeat; B4's ``m`` alone (``B4 m``, its float atomic max) is. The JSON object is the last line of the output (building the
graph prints before it). Run from the root of a checkout, or with
``PYTHONPATH=<an earlier checkout>`` for that checkout's kernels::

    PYTHONPATH=. python3 pygcn_tpu_torch/apps/kernel_bits.py > new.json
    python3 pygcn_tpu_torch/apps/kernel_bits.py --compare old.json new.json

``--compare`` prints, for each kernel and shape, whether the two trees'
first launches gave the same bits and whether each tree's two launches did;
where the trees' outputs differ in shape (a kernel that wrote per-tile
blocks in one tree and merged rows in the other) it marks the row
``changed_output`` with the two shapes. Files that record no shapes (bits
only, as a list) compare by bits alone.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

SHAPES = ((8, 8), (1, 40), (8, 128))
SLOPE = 0.2


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in _outputs(out):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def fingerprints() -> dict:
    from pygcn_tpu_torch.apps.train_fullgraph import clustered_dataset
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
    from pygcn_tpu_torch.ops.gat import build_gat_tiles_t

    graph = clustered_dataset(169_343, 13.3, 40, 128, 0, attention=True).graph
    tiles_t = build_gat_tiles_t(graph).to("cuda")
    bcsr = graph.hybrid.bcsr.to("cuda")
    n = graph.n_nodes
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def run(key, fn):
        launches = []
        for _ in range(2):
            got = fn()
            launches.append(_digest(got))
            shapes = [list(t.shape) for t in _outputs(got)]
            del got
        out[key] = {"bits": launches, "shapes": shapes}

    for h in (128, 40):
        x = torch.randn(n, h, device="cuda", generator=gen)
        run(f"B1 H={h}", lambda: b1.bcsr_spmm_cuda(bcsr, x, n_rows=n))
        run(f"B2 H={h}", lambda: b1.bcsr_spmm_stream_cuda(bcsr, x, n_rows=n))
    for h, f in SHAPES:
        lsrc, ldst = (torch.randn(n, h, device="cuda", generator=gen) for _ in range(2))
        s2, dnum = (torch.randn(n, h * f, device="cuda", generator=gen) for _ in range(2))
        dden = torch.randn(n, h, device="cuda", generator=gen)
        m = gta.tile_fwd_plain(bcsr, lsrc, ldst, s2, h, f, SLOPE)[2]
        bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
        shape = f"{h}x{f}"
        run(f"B3 {shape}", lambda: gta.tile_fwd_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE))
        run(f"B5 {shape}", lambda: gta.tile_bwd_dldst_cuda(bcsr, *bwd))
        run(f"B6 {shape}", lambda: gta.tile_bwd_sender_cuda(tiles_t, *bwd))
        run(f"B4 {shape}", lambda: gta.tile_fwd_stream_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE))
        run(f"B4 m {shape}",
            lambda: gta.tile_fwd_stream_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE)[2])
        run(f"B5s {shape}", lambda: gta.tile_bwd_dldst_stream_cuda(bcsr, *bwd))
        run(f"B6s {shape}", lambda: gta.tile_bwd_sender_stream_cuda(tiles_t, *bwd))
        sl2, sr2 = (torch.randn(n, h * f, device="cuda", generator=gen) for _ in range(2))
        a = torch.randn(h, f, device="cuda", generator=gen) / f ** 0.5
        m2 = gta.tile_v2_fwd_plain(bcsr, sl2, sr2, a, h, f, SLOPE)[2]
        bwd2 = (sl2, sr2, a, m2, dnum, dden, h, f, SLOPE)
        run(f"B7 {shape}", lambda: gta.tile_v2_fwd_cuda(bcsr, sl2, sr2, a, h, f, SLOPE))
        run(f"B8 {shape}", lambda: gta.tile_v2_bwd_recv_cuda(bcsr, *bwd2))
        run(f"B9 {shape}", lambda: gta.tile_v2_bwd_send_cuda(tiles_t, *bwd2))
    torch.cuda.synchronize()
    return out


def _entry(e) -> tuple:
    """(the two launches' digests, the outputs' shapes or None) of one
    fingerprint, in either file format."""
    return (e["bits"], e["shapes"]) if isinstance(e, dict) else (e, None)


def compare(old: dict, new: dict) -> dict:
    """Per kernel and shape: the same bits in both trees' first launches, and
    each tree's two launches alike; ``changed_output`` (old and new shapes)
    where both files record the outputs' shapes and they differ."""
    rows = {}
    for k in old:
        if k not in new:
            continue
        (o, o_shapes), (n, n_shapes) = _entry(old[k]), _entry(new[k])
        rows[k] = {"same_bits": o[0] == n[0], "old_repeats": o[0] == o[1],
                   "new_repeats": n[0] == n[1]}
        if None not in (o_shapes, n_shapes) and o_shapes != n_shapes:
            rows[k]["changed_output"] = [o_shapes, n_shapes]
    print(json.dumps(rows))
    same = [k for k, r in rows.items() if r["same_bits"]]
    changed = sorted(k for k, r in rows.items() if "changed_output" in r)
    print(f"{len(same)} of {len(rows)} kernel outputs have the same bits in both trees; "
          f"differ: {sorted(set(rows) - set(same) - set(changed))}; changed output: {changed}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"),
                    help="compare two fingerprint files instead of running")
    args = ap.parse_args(argv)
    if args.compare:
        old, new = (json.loads(open(p).read().splitlines()[-1]) for p in args.compare)
        compare(old, new)
        return
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bits runs the CUDA kernels; no card is available")
    print(json.dumps(fingerprints()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
