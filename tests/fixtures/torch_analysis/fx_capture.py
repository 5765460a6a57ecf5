"""Seeded violations: capture-sync / capture-pyif (CUDA graph captures)."""
import torch


class GraphedDelta:
    def _solve(self, blk):
        s = torch.sum(blk)
        scale = float(s)  # LINE: capture-sync (via the captured call)
        while torch.any(blk < 0):  # LINE: capture-pyif (via the call)
            blk = blk + 1
        return blk * scale

    def capture(self, graph, blk):
        self._solve(blk)  # warm-up, outside the capture: fine
        graph.capture_begin()
        try:
            y = torch.relu(blk)
            n = y.count_nonzero().item()  # LINE: capture-sync
            if torch.all(y > 0):  # LINE: capture-pyif
                y = y * 2
            self._solve(y)
        finally:
            graph.capture_end()
        return n

    def capture_with(self, blk):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = blk.cpu()  # LINE: capture-sync
            if blk is None:  # an identity check is host work: fine
                out = None
        return g, out

    def eager(self, blk):
        # no capture: host reads are this path's business
        if torch.any(blk > 0):
            return blk.sum().item()
        return 0.0
