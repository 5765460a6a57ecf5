"""Sharded serving driver: diversified slates drawn from a candidate set
larger than one device would hold (the torch counterpart of
``repro/launch/serve_sharded.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve_sharded \\
      --devices 2 --backend gloo --device cpu --candidates 20000 \\
      --dim 16 --slate 10 --window 0 4 --check

Starts ``--devices`` P ranks of a ``torch.distributed`` group, each a
subprocess of this interpreter (``repro_torch.distributed.spawn_ranks``:
never ``fork``, every rank under ``--timeout``, every rank ended when
one fails), joined by rendezvous on a file in a fresh temporary
directory.  Every rank builds the same request (``--seed``'s scores and
features, as ``repro``'s driver draws them, or the arrays of
``--inputs``) and serves it through ``Reranker(DPPRerankConfig(mesh=...))
.rerank``: the sharded top-k shortlist mask, then the candidate-sharded
greedy MAP, each rank on its ``(D, M/P)`` column shard.  ``--backend``
is ``nccl`` (one card a rank: rank r on card ``r % cards``) or ``gloo``
(any number of ranks, sharing one card or on the CPU); the default is
``nccl`` on ``--device cuda`` and ``gloo`` on ``--device cpu``.

``--window`` takes one or more windows (0 = exact Algorithm 1), served
in turn by the same ranks, with ``--slate``'s one slate size or one each.  ``--batch B`` serves B users' slates in one
call (per-user scores over shared features).  ``--check`` also runs the
single-device ``Reranker.rerank`` (``use_kernel=True``) on rank 0 and
requires the identical slate; keep M modest when checking on the CPU.

``--stream N`` also serves the request (``--batch 1``) through
``Reranker.stream`` in N-item chunks on every rank, the sharded state
staying on the rank between chunks: a warm pass, a timed pass (time to
first chunk, the whole stream, the update launches) and a third
synchronised around each collective.  Every rank requires its chunks to
concatenate to its own whole sharded slate, bit for bit, ``d_hist``
included.  The record gets ``repro``'s ``stream`` keys (``chunk_size``,
``first_chunk_s``, ``stream_total_s``, ``first_chunk_vs_whole`` and,
under ``--check``, ``check``) and, per rank, the stream's launches and
collectives.

Prints one JSON record: ``repro``'s keys for the first window, and under
``runs`` one entry a window with rank 0's slate (``indices``,
``d_hist``) and, per rank, its host wall, its collectives' host seconds
in a third call that synchronises around each collective, and its
kernels' launch counts in the steady call (``cuda.launch_counts()``).
Every rank's slate must equal rank 0's, bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=2,
                    help="P, the number of ranks")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--candidates", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--slate", type=int, nargs="+", default=[20],
                    help="slate size, one for all windows or one each")
    ap.add_argument("--shortlist", type=int, default=0,
                    help="top-C shortlist mask (0 = rank the full set)")
    ap.add_argument("--window", type=int, nargs="+", default=[0],
                    help="sliding diversity windows (0 = exact)")
    ap.add_argument("--alpha", type=float, default=3.0)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--stream", type=int, default=0,
                    help="also stream the slate in chunks of this size "
                         "(0 = whole slate only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inputs", default="",
                    help="an .npz with scores (B, M), feats (M, D) and "
                         "optionally mask (B, M), served instead of "
                         "--seed's draw")
    ap.add_argument("--check", action="store_true",
                    help="rank 0 holds the slate against the single-device "
                         "rerank")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the whole run, each collective too")
    ap.add_argument("--metrics-out", default="")
    # one rank of the group (set by the launcher)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    return ap


def _request(args):
    """The request every rank serves, as numpy arrays."""
    import numpy as np

    if args.inputs:
        with np.load(args.inputs) as z:
            scores = z["scores"]
            feats = z["feats"]
            mask = z["mask"] if "mask" in z.files else None
        return scores, feats, mask
    rng = np.random.default_rng(args.seed)
    M, D, B = args.candidates, args.dim, args.batch
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    scores = rng.uniform(size=(B, M)).astype(np.float32)
    return scores, feats, None


def _rank_device(args, rank: int):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve_rank(args) -> None:
    """One rank: join the group, serve every window, write its record."""
    import torch

    from repro_torch.distributed import init_group, leave_group, make_mesh
    from repro_torch.kernels import cuda
    from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

    dev = _rank_device(args, args.rank)
    init_group(args.backend, args.rank, args.devices, args.init_file,
               args.timeout, dev)
    mesh = make_mesh(device=dev)
    scores, feats, mask = _request(args)
    B, M = scores.shape
    single = B == 1
    req = RerankRequest(scores=scores[0] if single else scores,
                        feats=feats,
                        mask=None if mask is None else
                        (mask[0] if single else mask))
    runs = []
    for w, k in zip(args.window, args.slate):
        cfg = DPPRerankConfig(
            slate_size=k, shortlist=args.shortlist or M,
            alpha=args.alpha, eps=args.eps, window=w or None,
            mesh=mesh)
        rr = Reranker(cfg, device=dev)

        def call():
            t0 = time.perf_counter()
            out = rr.rerank(req)
            _sync(dev)
            return out, time.perf_counter() - t0

        _, t_first = call()
        cuda.reset_launch_counts()
        (sel, dh), t_steady = call()
        launches = cuda.launch_counts()
        mesh.reset_timing(True)
        _, t_timed = call()
        coll_s, colls = mesh.collective_s, mesh.collectives
        mesh.reset_timing(False)
        sel, dh = sel.reshape(B, -1), dh.reshape(B, -1)
        run = {
            "window": w or None,
            "n_selected": int((sel >= 0).sum()),
            "first_call_s": t_first, "steady_call_s": t_steady,
            "timed_call_s": t_timed, "collective_s": coll_s,
            "collectives": colls, "launches": launches,
            "indices": sel.cpu().tolist(), "d_hist": dh.cpu().tolist(),
        }
        if args.stream:
            run["stream"] = _stream_run(args, rr, req, dev, mesh, sel, dh,
                                        t_steady)
        if args.check and args.rank == 0:
            ref_cfg = DPPRerankConfig(
                slate_size=k, shortlist=args.shortlist or M,
                alpha=args.alpha, eps=args.eps, window=w or None,
                use_kernel=True)
            ref, _ = Reranker(ref_cfg, device=dev).rerank(req)
            if not torch.equal(ref.reshape(B, -1).cpu(), sel.cpu()):
                raise AssertionError(
                    f"window {w}: the sharded slate differs from the "
                    f"single-device rerank's")
            run["check"] = "ok (identical slate to single-device rerank)"
        runs.append(run)
    Path(args.out).write_text(json.dumps(
        {"rank": args.rank, "device": str(dev), "runs": runs}))
    leave_group()


def _stream_run(args, rr, req, dev, mesh, sel, dh, t_steady) -> dict:
    """``--stream``: this rank's stream of ``req`` in ``args.stream``-item
    chunks, held against its whole sharded slate ``(sel, dh)``."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.serving import Reranker

    srr = Reranker(dataclasses.replace(rr.cfg, chunk_size=args.stream),
                   device=dev)

    def stream():
        t0 = time.perf_counter()
        first, ids, ds = None, [], []
        for c, d in srr.stream(req):
            _sync(dev)
            if first is None:
                first = time.perf_counter() - t0
            ids.append(c)
            ds.append(d)
        return first, time.perf_counter() - t0, torch.cat(ids), torch.cat(ds)

    stream()  # warm
    cuda.reset_launch_counts()
    first, total, ids, ds = stream()
    launches = cuda.launch_counts()
    mesh.reset_timing(True)
    _, timed, _, _ = stream()
    coll_s, colls = mesh.collective_s, mesh.collectives
    mesh.reset_timing(False)
    # the stream ends at an eps-stop: the whole slate's tail is -1 / 0
    n = ids.numel()
    wi, wd = sel.reshape(-1), dh.reshape(-1)
    if not (torch.equal(ids, wi[:n]) and torch.equal(ds, wd[:n])
            and bool((wi[n:] < 0).all()) and bool((wd[n:] == 0).all())):
        raise AssertionError(
            f"window {rr.cfg.window}: rank {args.rank}'s streamed chunks "
            f"differ from its whole sharded slate")
    return {"chunk_size": args.stream, "first_chunk_s": first,
            "stream_total_s": total,
            "first_chunk_vs_whole": first / max(t_steady, 1e-9),
            "timed_stream_s": timed, "collective_s": coll_s,
            "collectives": colls, "launches": launches}


_STREAM_KEYS = ("chunk_size", "first_chunk_s", "stream_total_s",
                "first_chunk_vs_whole")


def _merge_stream(args, mine, steady) -> dict:
    """``repro``'s stream keys for a window (the slowest rank's times) and
    each rank's stream record."""
    first = max(run["stream"]["first_chunk_s"] for run in mine)
    return {
        "chunk_size": args.stream, "first_chunk_s": first,
        "stream_total_s": max(run["stream"]["stream_total_s"]
                              for run in mine),
        "first_chunk_vs_whole": first / max(steady, 1e-9),
        **({"check": "ok (chunks concatenate to the slate)"}
           if args.check else {}),
        "ranks": [{"rank": r, **run["stream"]} for r, run in enumerate(mine)],
    }


def _merge(args, parts, M, D, B) -> dict:
    """One record from the ranks' records; raises unless every rank's
    slate equals rank 0's bit for bit."""
    runs = []
    for i, (w, k) in enumerate(zip(args.window, args.slate)):
        mine = [p["runs"][i] for p in parts]
        head = mine[0]
        for r, run in enumerate(mine[1:], 1):
            if (run["indices"], run["d_hist"]) != (head["indices"],
                                                   head["d_hist"]):
                raise AssertionError(
                    f"window {w}: rank {r}'s slate differs from rank 0's")
        steady = max(run["steady_call_s"] for run in mine)
        runs.append({
            "window": w or None,
            "slate": k,
            "n_selected": head["n_selected"],
            "first_call_s": max(run["first_call_s"] for run in mine),
            "steady_call_s": steady,
            "us_per_step": steady / k * 1e6,
            "us_per_user_slate": steady / max(B, 1) * 1e6,
            "ranks_agree": True,
            **({"check": head["check"]} if "check" in head else {}),
            **({"stream": _merge_stream(args, mine, steady)}
               if args.stream else {}),
            "ranks": [{
                "rank": p["rank"], "device": p["device"],
                **{key: run[key] for key in (
                    "first_call_s", "steady_call_s", "timed_call_s",
                    "collective_s", "collectives", "launches")},
            } for p, run in zip(parts, mine)],
            "indices": head["indices"], "d_hist": head["d_hist"],
        })
    first = runs[0]
    return {
        "devices": args.devices, "backend": args.backend,
        "device": args.device, "candidates": M,
        "per_device_candidates": -(-M // args.devices), "dim": D,
        "slate": first["slate"], "batch": B,
        "window": [w or None for w in args.window],
        "shortlist": args.shortlist or None, "eps": args.eps,
        **{key: first[key] for key in (
            "n_selected", "first_call_s", "steady_call_s", "us_per_step",
            "us_per_user_slate")},
        **({"check": first["check"]} if "check" in first else {}),
        **({"stream": {key: first["stream"][key] for key in _STREAM_KEYS
                       + (("check",) if args.check else ())}}
           if args.stream else {}),
        "runs": runs,
    }


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    if len(args.slate) == 1:
        args.slate = args.slate * len(args.window)
    if len(args.slate) != len(args.window) or min(args.slate) < 1:
        raise SystemExit("--slate takes one positive size, or one for each "
                         "--window")
    if args.rank is not None:
        _serve_rank(args)
        return None
    if args.devices < 1:
        raise SystemExit("--devices must be >= 1")
    if args.stream < 0:
        raise SystemExit("--stream must be >= 0")
    from repro_torch.distributed import RankError, spawn_ranks

    B, M, D = args.batch, args.candidates, args.dim
    if args.inputs:
        import numpy as np

        with np.load(args.inputs) as z:
            (B, M), D = z["scores"].shape, z["feats"].shape[1]
    if args.stream and B > 1:
        raise SystemExit("--stream serves a single request; keep --batch 1")
    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as tmp:
        def rank_argv(r):
            return ["-m", "repro_torch.launch.serve_sharded", *argv,
                    "--backend", args.backend, "--rank", str(r),
                    "--init-file", str(Path(tmp) / "rendezvous"),
                    "--out", str(Path(tmp) / f"rank{r}.json")]

        try:
            spawn_ranks(rank_argv, args.devices, args.timeout)
        except RankError as e:
            print(f"serve_sharded: {e}", file=sys.stderr, flush=True)
            raise SystemExit(1) from None
        parts = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(args.devices)]
    out = _merge(args, parts, M, D, B)
    print(json.dumps(out), flush=True)
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
