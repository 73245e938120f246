"""repro_torch.sim — deterministic scenario simulation for the SVFF core
(mirrors ``repro.sim``).

The paper claims pause-based reconfiguration is transparent to live
tenants across ARBITRARY sequences of management operations (§IV, Tables
I/II). Hand-written tests cover a handful of sequences; this package
checks the claim property-style over thousands of randomized histories,
driving the port's REAL ``SVFFManager`` / ``DevicePool`` / scheduler /
pause / staging / records / checkpoint code with lightweight sim tenants
whose state lives on a torch device (the card by default) and simulated
device tokens.

Pieces
------
  clock       ``VirtualClock`` — deterministic virtual time + event log
  scenario    the op DSL (``Op``) and the seeded generator
              (``generate_scenario``): same seed -> same op sequence, equal
              to the JAX package's for every seed and config
  tenant      ``SimTenant`` — fp32 tensor state that is a pure function of
              ``(seed, steps_done)``; ``SimServeTenant`` — the toy paged
              serving engine; ``SimPipelineTenant`` — a serving tenant
              leading a pipeline gang of shell tenants; ``ServeSimTenant``
              — the pause-path benchmark's serving-shaped stub
  invariants  ``check_invariants`` (I1-I5, I8, I10, I12, I13, I14) +
              ``check_timings`` (I6) + ``check_pause_timings`` (I7),
              asserted after every op, and ``check_autoscale`` (I11)
              after every autoscale op
  chaos       crash-point catalogue (``CRASH_POINTS``), per-cell runner
              (``run_crash_case``) and ``crash_matrix`` over all 19
              points (``PORTED_POINTS``: the core ops', the four
              ``migrate_*`` and the four gang windows); I9 (recovery
              idempotence) lives in ``recover_manager``
  harness     ``ScenarioRunner`` / ``run_scenario`` — executes a scenario,
              records per-op outcomes (ok / atomically rejected) and the
              Table-II timing dict of every reconf; ``crash`` ops kill
              the manager at a crash point and rebuild it via
              ``SVFFManager.recover``; ``autoscale`` ops run the policy
              loop over the serving tenants, ``migrate_request`` ops
              live-migrate a request between them, ``reshape`` ops change
              the pipeline gang lead ``pg0``'s width

Not ported yet (ROADMAP Queue 1): the federation plane with I15/I16
(item 9).

Reproducing a failure
---------------------
Every ``InvariantViolation`` message carries ``seed=<s> policy=<p>
op#<i>``. Replay it exactly with:

    from repro_torch.sim import ScenarioConfig, ScenarioRunner
    ScenarioRunner(ScenarioConfig(seed=<s>, policy="<p>")).run()

``ScenarioResult.fingerprint()`` digests the whole outcome (per-op status
+ final tenant states); two runs of one seed always match, and match the
JAX package's.
"""
from repro_torch.sim.chaos import (CRASH_POINTS, PORTED_POINTS, CrashSpec,
                                   crash_matrix, recover_manager,
                                   run_crash_case, state_fingerprint)
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.harness import (OpResult, ScenarioResult,
                                     ScenarioRunner, run_scenario)
from repro_torch.sim.invariants import (InvariantViolation, check_autoscale,
                                        check_invariants,
                                        check_pause_timings, check_timings)
from repro_torch.sim.scenario import (ARRIVAL_PATTERNS, Op, OP_KINDS,
                                      ScenarioConfig, generate_scenario)
from repro_torch.sim.tenant import (ServeSimTenant, SimPipelineTenant,
                                    SimServeTenant, SimTenant)

__all__ = [
    "ARRIVAL_PATTERNS", "CRASH_POINTS", "CrashSpec", "InvariantViolation",
    "Op", "OP_KINDS", "OpResult", "PORTED_POINTS", "ScenarioConfig",
    "ScenarioResult", "ScenarioRunner", "ServeSimTenant",
    "SimPipelineTenant", "SimServeTenant",
    "SimTenant", "VirtualClock", "check_autoscale", "check_invariants",
    "check_pause_timings",
    "check_timings", "crash_matrix", "generate_scenario", "recover_manager",
    "run_crash_case", "run_scenario", "state_fingerprint",
]
