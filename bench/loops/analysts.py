"""Closed-loop analyst sessions on ``serve_db.QueryService``.

Set-up preloads the configuration's stream through the plane's ingest in
chunks of ``preload_chunk_rows`` on one thread and compacts every group,
then fills the dictionaries that the requests read; the preloaded
plane's publish gives the bytes the store holds a row. The traffic file's
keys: ``sessions`` closed-loop sessions, each cycling through its own
deck of ``deck`` requests made from the seed with the shares of ``mix``,
with no think time; time ranges uniform in start and in length
(``range_min_s`` to ``range_max_s``), clipped to the stored span; batches
of ``top_k`` rows a tablet, a ``check_rows_share`` of the queries keeping
every batch's rows for the check.

A mix entry is data: ``kind`` (query, aggregate or density), ``share``,
``schemes`` (a query's schemes, used in turn), and a ``filter`` tree of
``eq``, ``in``, ``and`` and ``or``, where a value ``$A``, ``$B`` or
``$C`` stands for the domain of the paper's query tier (gen.tiers),
``$d1`` and ``$d2`` for domains drawn by their popularity, and ``$set``
for a set of ``set_size`` codes of one of ``set_fields``; an aggregate
names its ``spec``, a density its ``field`` and ``value``.

Judged after the window: every drained request's count and every
batch's count, the rows of the sampled queries' batches, aggregates and
densities, against the reference over the stored events.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from bench import clients, gen, readback, reference
from bench.harness import Context, Outcome, Run


@dataclass
class Request:
    """One request of a deck: what the program is asked (``tree``, a
    filter tree of the port, or the density's field and value) and what
    the reference is asked (``pred`` in codes)."""

    kind: str  # query | aggregate | density
    scheme: str
    t0: int
    t1: int
    tree: object = None
    pred: tuple = ("true",)
    spec: Optional[dict] = None
    field: Optional[str] = None
    value: Optional[str] = None
    code: Optional[int] = None
    check_rows: bool = False
    label: str = ""


class DeckMaker:
    """Requests from a traffic's ``mix``, drawn from a seed. Every prefix
    of a deck keeps the mix's shares (a weighted round robin of its
    entries), and the domains and time ranges of an entry's requests are
    balanced draws (gen.balanced), so the part of a deck a window consumes
    asks nearly the same set of requests whatever the seed."""

    def __init__(self, traffic: dict, ev: gen.Events, rng: np.random.Generator):
        self.traffic, self.ev = traffic, ev
        self.tiers = {f"${t}": k for t, (k, _) in gen.tiers(ev).items()}
        self.sets: Dict[str, Tuple[tuple, np.ndarray]] = {}
        size = int(traffic.get("set_size", 0))
        for f in traffic.get("set_fields", []):
            n = len(self.ev.keys[f])
            codes = np.sort(rng.choice(n, min(size, n), replace=False))
            vocab = self.ev.vocab(f)
            self.sets[f] = (tuple(vocab[c] for c in codes), codes)

    def _value(self, fname: str, v: str, doms: Dict[str, int]):
        """(value string, code) of a literal, a tier's domain or a ``$dN``
        domain."""
        if v.startswith("$"):
            if fname not in ("domain", "referer"):
                raise ValueError(f"{v} stands for a domain; {fname} is no domain field")
            k = self.tiers[v] if v in self.tiers else doms[v]
            return gen.key_string(fname, k), self.ev.code(fname, k)
        return v, self.ev.value_code(fname, v)

    def build(self, spec, doms: Dict[str, int]):
        """(port filter tree, reference predicate) of a filter in data."""
        from repro_torch.core.filter import And, Eq, In, Or, TrueNode

        if spec is None:
            return TrueNode(), ("true",)
        (op, arg), = spec.items()
        if op == "eq":
            fname, v = arg
            s, code = self._value(fname, v, doms)
            return Eq(fname, s), ("eq", gen.FID[fname], -1 if code is None else code)
        if op == "in":
            fname, v = arg
            if v != "$set":
                raise ValueError(f"an in-filter takes $set, not {v!r}")
            values, codes = self.sets[fname]
            return In(fname, values), ("in", gen.FID[fname], codes)
        if op in ("and", "or"):
            parts = [self.build(p, doms) for p in arg]
            node = (And if op == "and" else Or)(*(t for t, _ in parts))
            return node, (op, *(p for _, p in parts))
        raise ValueError(f"unknown filter {op!r}")

    def deck(self, n: int, rng: np.random.Generator, phase: int = 0) -> List[Request]:
        """n requests, the entries' round robin started ``phase`` picks in."""
        mix = self.traffic["mix"]
        kinds = np.roll(gen.weighted_sequence([float(m["share"]) for m in mix], n), -phase)
        lo_s, hi_s = int(self.traffic["range_min_s"]), int(self.traffic["range_max_s"])
        span_s = self.ev.span_s
        draws = {}
        for i in range(len(mix)):
            k = int(np.sum(kinds == i))
            length = lo_s + np.floor(gen.balanced(rng, k, 2) * (hi_s - lo_s + 1)).astype(np.int64)
            start = np.floor(gen.balanced(rng, k, 3) * span_s).astype(np.int64)
            draws[i] = (gen.domains_by_popularity(gen.balanced(rng, k, 5)),
                        gen.domains_by_popularity(gen.balanced(rng, k, 7)),
                        start, np.minimum(start + length - 1, span_s - 1))
        seen = np.zeros(len(mix), np.int64)
        check_share = float(self.traffic.get("check_rows_share", 0.0))
        out: List[Request] = []
        for i in kinds:
            m, j = mix[i], int(seen[i])
            seen[i] += 1
            d1, d2, t0, t1 = (int(x[j]) for x in draws[i])
            doms = {"$d1": d1, "$d2": d2}
            schemes = m.get("schemes", [m["kind"]])
            label = m.get("label", m["kind"])
            if m["kind"] == "density":
                value, code = self._value(m["field"], m["value"], doms)
                out.append(Request("density", "density", t0, t1, field=m["field"],
                                   value=value, code=code, label=label))
                continue
            tree, pred = self.build(m.get("filter"), doms)
            out.append(Request(m["kind"], schemes[j % len(schemes)], t0, t1, tree=tree,
                               pred=pred, spec=m.get("spec"), label=label,
                               check_rows=m["kind"] == "query" and rng.random() < check_share))
        return out


def fields_read(traffic: dict) -> List[str]:
    """The fields a mix's requests name: their dictionaries are what the
    store needs filled."""
    out = set(traffic.get("set_fields", ()))

    def walk(f):
        if isinstance(f, dict):
            for op, arg in f.items():
                if op in ("eq", "in"):
                    out.add(arg[0])
                else:
                    for p in arg:
                        walk(p)

    for m in traffic["mix"]:
        walk(m.get("filter"))
        spec = m.get("spec") or {}
        out.update(spec.get("group_by", ()))
        if spec.get("value_field"):
            out.add(spec["value_field"])
        if m.get("field"):
            out.add(m["field"])
    return [f for f in gen.FIELDS if f in out]


def aggregate_spec(spec: dict):
    from repro_torch.core import AggregateSpec

    return AggregateSpec(group_by=tuple(spec["group_by"]), op=spec["op"],
                         value_field=spec.get("value_field"),
                         time_bucket_s=spec.get("time_bucket_s"))


@dataclass
class Answer:
    """One request as a session saw it."""

    req: Request
    session: int
    t_submit: float
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    batches: List[Tuple[float, float, int]] = field(default_factory=list)  # lo, hi, count
    rows: List[Tuple[np.ndarray, np.ndarray]] = field(default_factory=list)  # ts, cols
    agg: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    error: Optional[str] = None
    profile: Optional[Dict[str, float]] = None
    first_result_s: Optional[float] = None

    @property
    def count(self) -> int:
        return sum(c for _, _, c in self.batches)


def serve_one(session, req: Request, answer: Answer, spans) -> None:
    """Submit one request, hold its first result, drain the rest."""
    with spans.span("session.submit"):
        if req.kind == "query":
            q = session.submit(req.scheme, req.t0, req.t1, req.tree)
        elif req.kind == "aggregate":
            q = session.submit_aggregate(aggregate_spec(req.spec), req.t0, req.t1, req.tree)
        else:
            q = session.submit_density(req.field, req.value, req.t0, req.t1)
    stream = q.results(timeout=300)
    with spans.span("session.first_result"):
        first = next(stream, None)
    answer.t_first = time.perf_counter() if first is not None else None
    with spans.span("session.drain"):
        batches = [] if first is None else [first, *stream]
    answer.t_done = time.perf_counter()
    for rb in batches:
        answer.batches.append((float(rb.lo), float(rb.hi), int(rb.count)))
        if req.check_rows:
            answer.rows.append((np.asarray(rb.ts), np.asarray(rb.cols)))
        if req.kind == "aggregate":
            res = rb.blocks[0]
            answer.agg = (np.asarray(res.gids), np.asarray(res.values), np.asarray(res.counts))
    p = q.profile
    answer.profile = {"admission": p.admission_s, "plan": p.plan_s,
                      "density_fence": p.density_fence_s, "device_step": p.device_step_s,
                      "epilogue": p.epilogue_s}
    answer.first_result_s = q.first_result_s


class Analysts:
    """Closed-loop analyst sessions, each cycling through its own deck."""

    def __init__(self, service, traffic: dict, ev: gen.Events, seed: int, spans):
        self.service, self.spans = service, spans
        self.n = int(traffic["sessions"])
        n = int(traffic["deck"])
        maker = DeckMaker(traffic, ev, np.random.default_rng([int(seed), 1]))
        self.decks = [maker.deck(n, np.random.default_rng([int(seed), 2, i]), i * n // self.n)
                      for i in range(self.n)]

    def warm(self) -> List[Answer]:
        """One request of each entry and scheme, from one session."""
        seen, todo = set(), []
        for r in self.decks[0]:
            key = (r.kind, r.scheme, r.label)
            if key not in seen:
                seen.add(key)
                todo.append(r)
        session = self.service.session("warm")
        out = []
        for r in todo:
            a = Answer(r, -1, time.perf_counter())
            serve_one(session, r, a, self.spans)
            out.append(a)
        session.close()
        return out

    def run(self, window: clients.Window) -> Tuple[List[Answer], List[BaseException]]:
        answers: List[List[Answer]] = [[] for _ in range(self.n)]
        sessions = [self.service.session(f"analyst-{i}") for i in range(self.n)]

        def loop(i):
            deck, j = self.decks[i], 0
            time.sleep(max(window.t0 - time.perf_counter(), 0.0))
            while time.perf_counter() < window.t1:
                req = deck[j % len(deck)]
                j += 1
                a = Answer(req, i, time.perf_counter())
                answers[i].append(a)
                try:
                    serve_one(sessions[i], req, a, self.spans)
                except Exception as e:  # a failed request counts as failed, not as a crash
                    a.error = f"{type(e).__name__}: {e}"

        errors = clients.run_threads(loop, self.n, "analyst")
        for s in sessions:
            s.close()
        return [a for per in answers for a in per], errors


@dataclass
class ServeRun(Run):
    answers: List[Answer] = field(default_factory=list)

    def first_results(self) -> List[Answer]:
        """Answers whose first result came in the window."""
        return [a for a in self.answers if a.error is None and a.t_first is not None
                and a.t_first <= self.window.t1]

    def drained(self) -> int:
        """Requests fully drained in the window."""
        return sum(1 for a in self.answers if a.error is None and a.t_done is not None
                   and a.t_done <= self.window.t1)


def run(ctx: Context) -> Outcome:
    from repro_torch.serve_db import QueryService

    cfg, traffic = ctx.cfg, ctx.cell.traffic
    with ctx.phase("make events"):
        ev = gen.make_events(ctx.seed, cfg["events"], cfg["span_s"])
    with ctx.phase("fill dictionaries"):
        store = clients.make_store(ev, fields_read(traffic), ctx.device)
    with ctx.phase("preload and compact"):
        plane = clients.make_plane(cfg, ctx.device)
        tab = clients.preload(plane, ev, cfg, int(traffic["preload_chunk_rows"]), ctx.spans)
        store_bytes = readback.store_bytes(plane.publish())
    svc = QueryService(store, plane, top_k=int(traffic["top_k"]))
    try:
        with ctx.phase("decks"):
            analysts = Analysts(svc, traffic, ev, ctx.seed, ctx.spans)
        with ctx.phase("warm-up requests"):
            for a in analysts.warm():
                if a.error:
                    raise RuntimeError(f"warm-up request failed: {a.error}")
        ctx.sync()
        ctx.settle()
        ctx.window.start()
        t0 = time.perf_counter() + 0.01
        window = clients.Window(t0, t0 + ctx.seconds)
        answers, errors = analysts.run(window)
        ctx.sync()
    finally:
        svc.close()
    run = ServeRun(window, window.t0 - ctx.t_start, answers=answers,
                   store_bytes_per_row=store_bytes / ev.n)
    with ctx.phase("read the trace"):
        run.trace = ctx.window.stop(window.t0, window.t1, ctx.spans)
    peak = ctx.peak_bytes()
    if ctx.answers_hook is not None:
        ctx.answers_hook(answers, ev, ctx.device)

    failed = sum(a.error is not None for a in answers)
    checks: Dict[str, int] = {"errors": len(errors) + failed}
    tel = plane.telemetry()
    checks["overflow"] = int(tel["overflow"].sum() + tel["ix_overflow"].sum()
                             + tel["ag_overflow"].sum())
    del svc, plane
    qref = reference.QueryReference(
        ev.ts, ev.cols, tab, numeric={gen.FID[f]: ev.numeric(f) for f in ("bytes_out", "bytes_in")},
        radix={gen.FID[f]: len(ev.keys[f]) for f in gen.FIELDS}, device=ctx.device)
    with ctx.phase("judge"):
        checks.update(judge_answers(qref, answers, cfg, int(traffic["top_k"])))
    return Outcome(run, checks, len(answers), failed, peak)


def judge_answers(qref, answers: List[Answer], cfg: dict, top_k: int) -> Dict[str, int]:
    """Every answer against the reference: counts of every request and of
    every batch, the rows of the sampled queries' batches, aggregates and
    densities."""
    out = {"counts_off": 0, "batch_counts_off": 0, "rows_off": 0, "aggregates_off": 0,
           "densities_off": 0}
    for a in answers:
        if a.error is not None or a.t_done is None:
            continue
        r = a.req
        if r.kind == "density":
            want = qref.density(gen.FID[r.field], r.code, r.t0, r.t1, cfg["agg_bucket_s"])
            out["densities_off"] += int(a.count != want)
        elif r.kind == "aggregate":
            s = r.spec
            want = qref.aggregate(r.pred, [gen.FID[f] for f in s["group_by"]], s["op"],
                                  gen.FID.get(s.get("value_field")), s.get("time_bucket_s"),
                                  r.t0, r.t1)
            got = a.agg if a.agg is not None else (np.empty(0),) * 3
            out["aggregates_off"] += int(reference.aggregate_off(got, want) > 0)
        else:
            out["counts_off"] += int(a.count != qref.count(r.pred, r.t0, r.t1))
            for lo, hi, c in a.batches:
                out["batch_counts_off"] += int(c != qref.count(r.pred, int(lo), int(hi)))
            for (lo, hi, _), (ts, cols) in zip(a.batches, a.rows):
                out["rows_off"] += qref.batch_off(r.pred, int(lo), int(hi), top_k, ts, cols)
    return out
