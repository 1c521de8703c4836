"""
Shared steady-state timing for the benchmark scripts (bench.py and
benchmarks/scaling_bench.py).

Every fresh ``_rdf_mean`` call re-traces its block program and loads the
executable from the persistent compilation cache plus one device fetch
— costs a real trajectory pays once per 128-frame block, not per frame.
The
steady-state per-frame cost is therefore estimated as the two-length
difference (t(T_big) - t(T_small)) / (T_big - T_small), which cancels
the fixed per-call terms exactly. Each side is a min over repeats
(noise only ever ADDS time, so min is the right estimator); if
noise still swamps the delta after a retry, the T_big run's plain
per-frame average is returned as a conservative upper bound and the
result is flagged ``noise_limited`` instead of emitting a garbage
near-zero row.
"""

import time


def steady_state_seconds_per_frame(run, t_small=4, t_big=20, repeats=3):
    """Estimate the steady-state seconds/frame of ``run(T)``.

    ``run(T)`` must execute T frames end-to-end INCLUDING a host fetch
    of the result. Both block
    shapes are warmed (compile + cache load) before timing.

    Returns (seconds_per_frame, noise_limited, last_result).
    """
    run(t_small)  # warm/compile both block shapes
    run(t_big)

    def best_of(T):
        best, out = float("inf"), None
        for _ in range(repeats):
            t0 = time.time()
            out = run(T)
            best = min(best, time.time() - t0)
        return best, out

    dt_small, _ = best_of(t_small)
    dt_big, result = best_of(t_big)
    if dt_big <= dt_small * 1.05:  # noise swamped the delta; one retry
        dt_small = min(dt_small, best_of(t_small)[0])
        dt_big = min(dt_big, best_of(t_big)[0])
    if dt_big <= dt_small * 1.05:
        # still indistinguishable: report the conservative upper bound
        return dt_big / t_big, True, result
    return (dt_big - dt_small) / (t_big - t_small), False, result
