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

``--router N`` serves N single requests instead through the
continuous-batching router on the mesh (``Reranker.submit`` /
``RerankRouter`` with ``cfg.mesh``), one router a window, ``--slots``
lanes advancing ``--chunk`` steps a pump, ``repro``'s router on a mesh
(its ``test_router_multidevice_sharded_parity``).  Every rank builds the
same requests: from ``--seed``, pools of log-uniform size up to
``--candidates`` (the router's bucket) drawn from one catalog, uniform
scores, a 10% seen mask on every third, and ``--deadline`` seconds each
(0: none); or from ``--inputs``, whose ``scores (N, M)`` / ``mask`` rows
are the requests, cut to ``sizes (N,)`` columns and given ``deadlines
(N,)`` (0: none) when the file has them.  Request i's slate size is
``k // 2`` to ``k`` of the window's ``--slate k``, from ``--seed``.
Every rank submits them in the same order and pumps until every handle
is done, once to warm and once measured.  Deadlines are decided on rank
0 alone and replicated to every rank (``serving.router``), so every
rank's handles, ``timed_out`` flags included, must equal rank 0's, bit
for bit.  ``--check`` also serves each request through the per-request
sharded ``Reranker.rerank`` on the same ranks: each slate must equal
its ids (a timed-out slate their prefix), and ``rerank_max_abs_diff``
records the largest ``d_hist`` difference.  Each run's record adds
``pumps``, each rank's mean host wall a pump by span
(``router.pump`` and its ``sync`` / ``decide`` / ``evict`` / ``admit``
/ ``launch`` / ``materialize`` children; ``decide`` is the decision
collective's), its ``decisions`` (the collective's calls), the update
launches and the TTFC of every handle; ``indices``, ``d_hist`` (padded with -1 / 0 to ``k``) and
``timed_out`` are rank 0's.

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
    ap.add_argument("--router", type=int, default=0,
                    help="serve this many single requests through the "
                         "continuous-batching router on the mesh instead "
                         "(0 = the whole-slate rerank); deadlines are "
                         "decided on rank 0 and sent to every rank; the "
                         "record adds pumps, pump_us by span, decisions, "
                         "launches and ttfc_s per rank")
    ap.add_argument("--slots", type=int, default=8,
                    help="--router: the router's lanes")
    ap.add_argument("--chunk", type=int, default=8,
                    help="--router: greedy steps a pump")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="--router: seconds each request may take "
                         "(0 = none; --inputs may give one each)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inputs", default="",
                    help="an .npz with scores (B, M), feats (M, D) and "
                         "optionally mask (B, M), served instead of "
                         "--seed's draw")
    ap.add_argument("--check", action="store_true",
                    help="rank 0 holds the slate against the single-device "
                         "rerank (--router: every rank holds each slate "
                         "against the per-request sharded rerank)")
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
    if args.router:
        runs = [_router_run(args, mesh, dev, w, k)
                for w, k in zip(args.window, args.slate)]
        Path(args.out).write_text(json.dumps(
            {"rank": args.rank, "device": str(dev), "runs": runs}))
        leave_group()
        return
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


PUMP_SPANS = ("sync", "decide", "evict", "admit", "launch", "materialize")


def _router_requests(args, dev, k):
    """The ``--router`` requests, the same on every rank: a list of
    ``RerankRequest`` on ``dev`` with slate sizes in ``[k // 2, k]``."""
    import numpy as np
    import torch

    from repro_torch.serving import RerankRequest

    n = args.router
    rng = np.random.default_rng(args.seed)
    if args.inputs:
        with np.load(args.inputs) as z:
            scores, feats = z["scores"], z["feats"]
            mask = z["mask"] if "mask" in z.files else None
            M = scores.shape[1]
            sizes = z["sizes"] if "sizes" in z.files else np.full(n, M)
            dls = (z["deadlines"] if "deadlines" in z.files
                   else np.full(n, args.deadline))
        if scores.shape[0] < n:
            raise SystemExit(f"--inputs holds {scores.shape[0]} requests, "
                             f"--router asks for {n}")
    else:
        M, D = args.candidates, args.dim
        feats = rng.normal(size=(M, D)).astype(np.float32)
        feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                            1e-12)
        scores = rng.uniform(size=(n, M)).astype(np.float32)
        mask = rng.uniform(size=(n, M)) >= 0.1
        mask[np.arange(n) % 3 != 2] = True
        lo = max(2 * k, M // 16)
        sizes = np.exp(rng.uniform(np.log(lo), np.log(M), size=n)).astype(
            np.int64)
        dls = np.full(n, args.deadline)
    ks = k // 2 + np.round(rng.uniform(size=n) * (k - k // 2)).astype(int)
    catalog = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
    reqs = []
    for i in range(n):
        m = int(min(sizes[i], M))
        reqs.append(RerankRequest(
            scores=torch.from_numpy(scores[i, :m].copy()).to(dev),
            feats=catalog[:m],
            mask=None if mask is None else torch.from_numpy(
                mask[i, :m].copy()).to(dev),
            slate_size=int(ks[i]),
            deadline=float(dls[i]) if dls[i] > 0 else None, rid=i))
    return reqs, M


def _router_run(args, mesh, dev, w, k) -> dict:
    """``--router``: one window's requests through the router on the mesh
    (warm, then measured), and, under ``--check``, each against the
    per-request sharded rerank on the same ranks."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.kernels import cuda
    from repro_torch.serving import DPPRerankConfig, Reranker, RouterConfig

    reqs, M = _router_requests(args, dev, k)
    cfg = DPPRerankConfig(slate_size=k, shortlist=args.shortlist or M,
                          alpha=args.alpha, eps=args.eps, window=w or None,
                          mesh=mesh)
    rcfg = RouterConfig(slots=args.slots, chunk_size=args.chunk,
                        max_queue=len(reqs), max_candidates=M)

    def serve():
        rr = Reranker(cfg, router_config=rcfg, device=dev)
        handles = [rr.submit(r) for r in reqs]
        pumps = 0
        while not all(h.done for h in handles):
            rr.router.pump()
            pumps += 1
        rr.router.drain()  # the last chunk's copies
        _sync(dev)
        return rr, handles, pumps

    serve()  # warm: the kernels' library, the first collectives
    obs.disable()
    obs.enable(obs.ObsConfig(enabled=True))
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rr, handles, pumps = serve()
    wall = time.perf_counter() - t0
    launches = cuda.launch_counts()
    spans = obs.tracer().finished()
    obs.disable()
    router = rr.router
    n_pump = sum(1 for sp in spans if sp["name"] == "router.pump")
    split = {"pump": sum(sp["dur_us"] for sp in spans
                         if sp["name"] == "router.pump") / n_pump}
    split.update({p: sum(sp["dur_us"] for sp in spans
                         if sp["name"] == f"router.pump.{p}") / n_pump
                  for p in PUMP_SPANS})
    ids = np.full((len(reqs), k), -1, np.int64)
    dh = np.zeros((len(reqs), k), np.float32)
    for i, h in enumerate(handles):
        gi, gd = h.slate()
        ids[i, :len(gi)], dh[i, :len(gd)] = gi, gd
    run = {
        "window": w or None, "requests": len(reqs), "pumps": pumps,
        "wall_s": wall, "pump_us": split,
        "decisions": sum(1 for sp in spans
                         if sp["name"] == "router.pump.decide"),
        "launches": launches,
        "chunks_launched": router.stats.chunks_launched,
        "ttfc_s": [h.ttfc for h in handles],
        "timed_out": [h.timed_out for h in handles],
        "delivered": [h.delivered for h in handles],
        "slate_sizes": [r.slate_size for r in reqs],
        "indices": ids.tolist(), "d_hist": dh.tolist(),
    }
    if args.check:
        err = 0.0
        for i, (req, h) in enumerate(zip(reqs, handles)):
            sel, d = rr.rerank(req)
            sel, d = sel.cpu().numpy(), d.cpu().numpy()
            gi, gd = h.slate()
            if not np.array_equal(gi, sel[:len(gi)]) or (
                    not h.timed_out and len(gi) != len(sel)):
                raise AssertionError(
                    f"window {w}: request {i}'s router slate differs from "
                    f"its sharded rerank")
            if len(gi):
                err = max(err, float(np.abs(gd - d[:len(gd)]).max()))
        run["check"] = "ok (each slate the per-request sharded rerank's)"
        run["rerank_max_abs_diff"] = err
    return run


def _merge_router(args, parts) -> dict:
    """The ``--router`` record from the ranks' records; raises unless every
    rank's handles equal rank 0's bit for bit."""
    runs = []
    for i, w in enumerate(args.window):
        mine = [p["runs"][i] for p in parts]
        head = mine[0]
        for r, run in enumerate(mine[1:], 1):
            for key in ("indices", "d_hist", "timed_out", "delivered",
                        "pumps"):
                if run[key] != head[key]:
                    raise AssertionError(
                        f"window {w}: rank {r}'s {key} differ from rank 0's")
        runs.append({
            **{key: head[key] for key in (
                "window", "requests", "pumps", "slate_sizes", "timed_out",
                "delivered", "indices", "d_hist")},
            "slate": args.slate[i], "ranks_agree": True,
            **{key: head[key] for key in ("check", "rerank_max_abs_diff")
               if key in head},
            "ranks": [{"rank": p["rank"], "device": p["device"],
                       **{key: run[key] for key in (
                           "wall_s", "pump_us", "decisions",
                           "launches", "chunks_launched", "ttfc_s")}}
                      for p, run in zip(parts, mine)],
        })
    return {"devices": args.devices, "backend": args.backend,
            "device": args.device, "router": args.router,
            "slots": args.slots, "chunk": args.chunk,
            "window": [w or None for w in args.window],
            "shortlist": args.shortlist or None, "eps": args.eps,
            "runs": runs}


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
    if args.router < 0 or (args.router and args.stream):
        raise SystemExit("--router takes a request count, without --stream")
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
    out = (_merge_router(args, parts) if args.router
           else _merge(args, parts, M, D, B))
    print(json.dumps(out), flush=True)
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
