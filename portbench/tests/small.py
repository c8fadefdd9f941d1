"""Shared sizes of the benchmark's CPU tests: every cell driven end to end
at two worlds and a few steps, the program's kernels on their plain
versions."""

# Per traffic driver: the mix's parameters cut to a CPU-sized run, and the
# env's decision interval cut to 2 physics steps.
SMALL = {
    "replay": ({"worlds": 2, "k_steps": 2, "episode_steps": 2, "settle_steps": 2}, {}),
    "env": ({"envs": 2, "episode_steps": 2, "warmup_steps": 1}, {"decision_interval": 2}),
}


def small_run(bench, cell_name: str, seed: int = 20260101, trace=False):
    """One run of the cell at the CPU size, as ``harness.execute`` gives it."""
    from portbench.harness import execute

    cell = bench.cell(cell_name)
    overrides, driver_kw = SMALL[bench.traffic(cell["traffic"])["driver"]]
    return execute(bench, cell, seed, 0.01, trace, "cpu", overrides=overrides,
                   driver_kw=driver_kw, log=lambda _m: None)


def small_readings(bench, cell_name: str, controls, seed: int = 20260101):
    """The program's and the controls' readings of the cell at the CPU size,
    as ``control.readings`` gives them."""
    from portbench.control import readings

    cell = bench.cell(cell_name)
    overrides, driver_kw = SMALL[bench.traffic(cell["traffic"])["driver"]]
    return readings(bench, cell, seed, 0.01, "cpu", controls, overrides=overrides,
                    driver_kw=driver_kw)
