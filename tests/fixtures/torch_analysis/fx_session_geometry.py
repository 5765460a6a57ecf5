"""Seeded violations: session-geometry (mutable resume geometry)."""


class WobblySession:
    def __init__(self, spec, w):
        self.spec = spec
        self.w = w
        self._launch = None

    def next_chunk(self, n):
        if self._launch is None:
            self._launch = greedy_chunk_launcher(  # noqa: F821
                self.spec, self._state, V=self._V, chunk_size=n)
        return self._launch()

    def extend(self, V_new):
        self.w = self.w + 1  # LINE: session-geometry write
        self._delta(V_new)
        self._delta(V_new)  # LINE: session-geometry 2nd extend site

    def rescore(self, V_new):
        self._delta(V_new)

    def _delta(self, blk):
        return window_solve(self.w, blk)  # noqa: F821


class SteadySession:
    """Write-once geometry, one launch site per family: proves clean."""

    def __init__(self, spec, w):
        self.spec = spec
        self.w = w
        self._launch = None

    def next_chunk(self, n):
        if self._launch is None or self._launch[0] != n:
            self._launch = n, greedy_chunk_launcher(  # noqa: F821
                self.spec, self._state, V=self._V, chunk_size=n)
        return self._launch[1]()

    def extend(self, V_new):
        self._delta(V_new)

    def rescore(self, V_new):
        self._delta(V_new)

    def _delta(self, blk):
        return self._solve(blk)

    def _solve(self, blk):
        return window_solve(self.w, blk)  # noqa: F821
