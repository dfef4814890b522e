"""The leaf level of the rollup's job DAG, drained by one worker.

A traffic file names this work with ``"work": "rollup_leaves"``. Set-up
builds the configuration's shape family, plans the mix's blocks with the
program's orchestrator into its in-memory proof store, and queues the
family's leaf jobs (ops and dummies) in plan order (``leafqueue.py``).
Each window call is one call of the mix's worker loop:
``{"loop": "process_ready_batch", "max_batch": B}`` (the fleet's batched
drain) or ``{"loop": "process_next_job"}`` (the CLI's and the reference
qbench's loop). The check (``ref/judge.py``) reads every proof the worker
was asked for.
"""

from __future__ import annotations

from portbench import traffic
from portbench.leafqueue import LeafQueue


def family_names(cfg: dict) -> list[str]:
    from portbench.ref.rollup import circuits as rc
    return list(rc.SHAPE_A_OPS if cfg["family"] == "A" else rc.SHAPE_B_OPS)


def leaf_types(cfg: dict) -> set[int]:
    """Circuit types of the family's leaf jobs: its ops and its dummies."""
    from portbench.ref.rollup import orchestrator as ro
    names = family_names(cfg)
    return {int(ro.OP_CT[n]) for n in names} | \
        {int(ro.DUMMY_CT[n]) for n in names}


def build_family(prog, cfg: dict, device):
    """(toolbox, family): the configuration's shape family, every member
    preprocessed (its verifier data and the family's allowed roots)."""
    tb = prog.circuits.CircuitToolbox(prog.params(cfg), device=device)
    fam = tb.family_a if cfg["family"] == "A" else tb.family_b
    for name in family_names(cfg):
        tb.allowed_root(name)
    return tb, fam


def plan(prog, cfg: dict, plain: dict):
    """Plan the traffic's blocks with the program's orchestrator: (store,
    leaf jobs of the family to enqueue, in plan order)."""
    params = prog.params(cfg)
    city = prog.city_store.CityStore(
        user_tree_height=params.user_tree_height,
        deposit_tree_height=params.deposit_tree_height,
        withdrawal_tree_height=params.withdrawal_tree_height)
    store = prog.proof_store.MemoryProofStore()
    orch = prog.orchestrator.Orchestrator(city, store,
                                          prog.queues.QueueHub(),
                                          params=params)
    traffic.apply_genesis(city, plain["genesis"])
    types_ = leaf_types(cfg)
    jobs = []
    for blk in plain["blocks"]:
        planned = orch.plan_block(blk["checkpoint"], traffic.block_requests(
            prog.orchestrator, blk["requests"]))
        if blk["enqueue"]:
            jobs.extend(j.to_bytes() for j in planned.leaf_jobs
                        if int(j.circuit_type) in types_)
    return store, jobs


class Work:
    """One run's worker over the planned backlog. `ctx` carries ``prog``
    (``harness.Program``), ``cfg``, ``mix``, ``seed``, ``device`` and
    ``cache`` (kept across runs of one process: the family builds)."""

    def __init__(self, ctx):
        self.ctx = ctx
        prog, cfg = ctx.prog, ctx.cfg
        self.key = ("program", cfg["name"], str(ctx.device))
        if self.key not in ctx.cache:
            ctx.cache[self.key] = build_family(prog, cfg, ctx.device)
        self.toolbox, self.family = ctx.cache[self.key]
        self.plain = traffic.generate(ctx.mix, ctx.seed)
        self.store, self.jobs = plan(prog, cfg, self.plain)
        self.hub = LeafQueue(self.jobs, prog.queues.Q_JOB)
        self.worker = prog.worker.Worker(self.toolbox, self.store, self.hub)
        self.loop = ctx.mix["worker"]
        self.slot = {}            # mid -> its place among its call's jobs

    def pending(self) -> int:
        return len(self.hub)

    def call(self) -> int:
        """One call of the worker loop; the jobs it proved and acked."""
        n0 = len(self.hub.received)
        loop = self.loop
        if loop["loop"] == "process_ready_batch":
            done = self.worker.process_ready_batch(
                max_batch=int(loop["max_batch"]))
        elif loop["loop"] == "process_next_job":
            done = int(self.worker.process_next_job())
        else:
            raise ValueError(f"unknown worker loop {loop['loop']!r}")
        for i, mid in enumerate(list(self.hub.received)[n0:]):
            self.slot[mid] = i
        return done

    def counters(self) -> dict:
        """The program's own counters, read by the per-layer metrics."""
        return {"batched_groups": list(self.worker.batched_groups)}

    def outputs(self, first_window_job: int) -> list:
        """Every job the worker was asked for, with its proof (None where
        unacked or unwritten), in pop order; `first_window_job`: the count
        of jobs popped before the window."""
        from portbench.ref import convert as ref_convert
        prog = self.ctx.prog
        acked = set(self.hub.acked)
        out = []
        for i, (mid, msg) in enumerate(self.hub.received.items()):
            job = prog.worker.JobID.from_bytes(msg)
            raw = self.store.get_proof(job.output_proof_id()) \
                if mid in acked else None
            proof = None if raw is None else ref_convert.proof_to_plain(
                prog.circuits.decode_proof(raw))
            out.append({"job": msg.hex(), "proof": proof,
                        "in_window": i >= first_window_job,
                        "slot": self.slot.get(mid, 0)})
        return out

    def jobs_popped(self) -> int:
        return len(self.hub.received)

    def backlog_left(self) -> int:
        return len(self.jobs) - len(self.hub.received)

    def free(self) -> None:
        del self.worker, self.store, self.hub
        self.toolbox = self.family = None
        if not self.ctx.cache.get("keep"):
            self.ctx.cache.pop(self.key, None)

    def judge(self, outputs: list, cache_dir) -> dict:
        from portbench.ref import judge
        ctx = self.ctx
        return judge.judge(ctx.cfg, ctx.mix, self.plain, outputs, ctx.seed,
                           device=ctx.device, cache=ctx.cache,
                           cache_dir=cache_dir)


def start(ctx) -> Work:
    return Work(ctx)
