"""Seeded violations: host-sync-hot (syncs in pump() hot phases)."""
import numpy as np
import torch


class LeakyRouter:
    def pump(self):
        with obs.span("router.pump"):  # noqa: F821 (parsed, not run)
            n = self.state.stopped.sum().item()  # LINE: host-sync-hot
            torch.cuda.synchronize()  # LINE: host-sync-hot
            with obs.span("router.pump.launch"):  # noqa: F821
                ids = self.sel.cpu()  # LINE: host-sync-hot
            with obs.span("router.pump.sync"):  # noqa: F821
                self.done.synchronize()  # allowed: *.sync span
                flags = self.state.stopped.numpy()  # allowed
            lane = bool(flags[0])  # not flagged: the host copy above
            with obs.span("router.pump.materialize"):  # noqa: F821
                out = np.asarray(self.slate)  # allowed: *.materialize
        return n, ids, lane, out

    def not_pump(self):
        # syncs outside pump() are not this rule's business
        return self.slate.tolist()
