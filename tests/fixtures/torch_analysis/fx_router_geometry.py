"""Seeded violations: router-geometry (mutable launch geometry)."""


class WobblyRouter:
    def __init__(self, spec, chunk):
        self.spec = spec
        self.chunk = chunk
        self._state = None
        self._V = None
        self._D = None
        self._run = None

    def admit(self, feats):
        self._D = feats.shape[0]  # LINE: router-geometry lazy unguarded
        if self._state is None:
            self._state, self._V = greedy_slots_init(  # noqa: F821
                self.spec, 4, self._D, 64
            )
        self._run = greedy_chunk_launcher(  # LINE: launcher unguarded
            self.spec, self._state, V=self._V, chunk_size=self.chunk
        )

    def pump(self):
        self.chunk = self.chunk + 1  # LINE: router-geometry write
        return self._run()

    def flush(self):
        return self._run()  # LINE: router-geometry 2nd launch site


class SteadyRouter:
    """Write-once geometry, one build and one launch site: proves clean."""

    def __init__(self, spec, chunk):
        self.spec = spec
        self.chunk = chunk
        self._state = None
        self._D = None
        self._run = None

    def admit(self, feats):
        if self._D is None:
            self._D = feats.shape[0]
        if self._state is None:
            self._state, self._V = greedy_slots_init(  # noqa: F821
                self.spec, 4, self._D, 64
            )
            self._run = greedy_chunk_launcher(  # noqa: F821
                self.spec, self._state, V=self._V, chunk_size=self.chunk
            )

    def pump(self):
        return self._run()
