"""A fake clock for tests of timing code: `perf_counter` advances by one
tick a reading and `sleep` advances by its argument, with no real
waiting. With a tick and sleeps that are powers of two, every difference
the timing code takes is exact, so a test can assert the measured times
equal known values instead of bounding a wall clock on a shared host.

    clock = FakeClock()
    monkeypatch.setattr(some_timing_module, "time", clock)
"""


class FakeClock:
    TICK = 2.0 ** -12  # seconds a perf_counter reading costs

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += self.TICK
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += seconds

    def time(self) -> float:
        return self.perf_counter()
