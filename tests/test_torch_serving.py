"""The port's tuning-as-a-service layer against the reference's, on the CPU.

Each case of ``tests/test_serving.py`` runs through both packages wherever
both can take the same input:

* winner keys, payloads and the merge policy: the port's records are the
  reference's byte for byte, in both store backends;
* ``best_config`` resolves hit / stale / nearest / miss on the same records
  to the same answers, and the HTTP endpoint serves the same JSON;
* job ids, unit digests and queue claims: the cost-model job a miss
  enqueues has the reference's id, claims are exclusive, stale claims are
  stolen, done markers are atomic;
* a fleet worker fills a miss with store values byte-identical to the
  reference's fleet run and to the port's serial run, after which the query
  is a hit;
* concurrent readers never see a torn winner while a writer updates it;
* the device label: a ``cuda`` winner is keyed by the card's name (``cpu``
  for the plain versions), so it never answers a query for a cost-model
  chip or for the CPU, and a ``cuda`` job's worker raises where there is no
  card;
* the port's static gate guards the serving layer's pacing knobs out of
  provenance and its serve-dir plumbing out of identity sinks, as the
  reference's does.

Tolerance is exact everywhere.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

import repro.serving as ref_serving
from repro.core import ExperimentDesign as RefDesign
from repro.core import TuningSession as RefSession
from repro.core import TuningSpec as RefSpec
from repro.core.stores import make_store as ref_make_store
from repro.core.workunits import unit_digest as ref_unit_digest
from repro.serving.http import ServingState as RefServingState
from repro.serving.http import make_server as ref_make_server
from repro.serving.winners import parse_config_from_store_key as ref_parse_config
from repro.serving.winners import parse_winner_key as ref_parse_winner_key
from repro.serving.winners import winner_key as ref_winner_key
from repro_torch import ExperimentDesign, TuningSession, TuningSpec, build_units
from repro_torch.core import MeasurementStore
from repro_torch.core import clock as port_clock
from repro_torch.core.stores import (
    SqliteMeasurementStore,
    absorb_winners,
    make_store,
    merge_winner_payloads,
)
from repro_torch.core.workunits import unit_digest
from repro_torch.serving import (
    FleetWorker,
    JobQueue,
    ServeResult,
    WinnerRecord,
    best_config,
    collect_jobs,
    default_miss_spec,
    device_label,
    index_winners,
    job_id_for_spec,
    lookup_winner,
    nearest_winner,
    record_winner,
    spec_geometry,
)
from repro_torch.serving.__main__ import main as serving_cli
from repro_torch.serving.http import ServingState, make_server
from repro_torch.serving.winners import (
    parse_config_from_store_key,
    parse_winner_key,
    winner_key,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3"


def rec(kernel="add", x=8192, y=8192, device="v5e", value=1.0, fresh=100.0,
        config=None, cls=WinnerRecord, **kw):
    return cls(kernel=kernel, x=x, y=y, device=device, config=config or {"t_x": 4},
               value=value, fresh=fresh, **kw)


def ref_rec(**kw):
    return rec(cls=ref_serving.WinnerRecord, **kw)


SMOKE_KW = dict(kernel="add", backend="costmodel", backend_kwargs={"chip": "v5e"},
                algorithms=("rs",), seed=11)
SMOKE_DESIGN = dict(sample_sizes=(25,), n_experiments=(4,), final_repeats=3)
SMOKE_SPEC = TuningSpec(**SMOKE_KW, design=ExperimentDesign(**SMOKE_DESIGN))
REF_SMOKE_SPEC = RefSpec(**SMOKE_KW, design=RefDesign(**SMOKE_DESIGN))
#: the cuda backend's plain versions at a small size: a job a CPU can run
CPU_JOB = TuningSpec(kernel="mandelbrot", backend="cuda",
                     backend_kwargs={"x": 64, "y": 128, "device": "cpu", "repeats": 1},
                     algorithms=("rs",), design=ExperimentDesign(
                         sample_sizes=(6,), n_experiments=(2,), final_repeats=2))


@contextlib.contextmanager
def ticking_clock():
    """The port's clock ticking 1.0 a reading: every timed repeat measures
    exactly 1.0, so runs of a ``device="cpu"`` job are deterministic."""
    ticks = itertools.count()
    port_clock.set_timer(lambda: float(next(ticks)))
    try:
        yield
    finally:
        port_clock.set_timer(None)


@pytest.fixture
def named_card(monkeypatch):
    """A card present and named, as the H100 host reports itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: CARD)


# ------------------------------------------------------------- key + payload


def test_winner_key_roundtrip():
    key = winner_key("harris", 4096, 2048, "v4")
    assert key == ref_winner_key("harris", 4096, 2048, "v4") == "harris|x=4096|y=2048|v4"
    assert winner_key("harris", 8192, 8192, CARD) == ref_winner_key("harris", 8192, 8192, CARD)
    for k in (key, "not-a-winner-key", "k|x=a|y=2|d", f"h|x=1|y=2|{CARD}"):
        assert parse_winner_key(k) == ref_parse_winner_key(k)
    assert parse_winner_key(key) == ("harris", 4096, 2048, "v4")
    assert parse_winner_key("not-a-winner-key") is None


def test_parse_config_from_store_key_skips_final_marker():
    for key in ("add/v5e/seed=17|t_x=9,t_y=16,w_x=3.5,name=foo|final3",
                "harris/h100/seed=3|t_x=1,t_y=2,t_z=4,w_x=1,w_y=1,w_z=2|final10",
                "no-config-here"):
        assert parse_config_from_store_key(key) == ref_parse_config(key)
    assert parse_config_from_store_key(
        "add/v5e/seed=17|t_x=9,t_y=16,w_x=3.5,name=foo|final3"
    ) == {"t_x": 9, "t_y": 16, "w_x": 3.5, "name": "foo"}


def test_merge_policy_lower_value_wins():
    worse, better = rec(value=2.0, fresh=50.0), rec(value=1.0, fresh=10.0)
    assert worse.to_payload() == ref_rec(value=2.0, fresh=50.0).to_payload()
    for old, new in ((worse, better), (better, worse)):
        merged = merge_winner_payloads(old.to_payload(), new.to_payload())
        assert merged == ref_serving.winners.merge_winner_payloads(
            old.to_payload(), new.to_payload())
        assert json.loads(merged)["value"] == 1.0
        assert json.loads(merged)["fresh"] == 50.0


def test_merge_policy_tie_keeps_newer_config():
    a = rec(value=1.0, fresh=10.0, config={"t_x": 1}).to_payload()
    b = rec(value=1.0, fresh=20.0, config={"t_x": 2}).to_payload()
    assert json.loads(merge_winner_payloads(a, b))["config"] == {"t_x": 2}
    assert json.loads(merge_winner_payloads(b, a))["config"] == {"t_x": 2}


def test_merge_policy_unparseable_loses():
    good = rec(value=5.0).to_payload()
    assert merge_winner_payloads("not json{", good) == good
    assert merge_winner_payloads(None, good) == good
    assert json.loads(merge_winner_payloads(good, "not json{"))["value"] == 5.0


# ------------------------------------------------------ store round-tripping


@pytest.mark.parametrize("kind", ["json", "sqlite"])
def test_winners_survive_save_load(tmp_path, kind):
    """A store the port wrote and one the reference wrote the same way,
    each reopened by the port, serve the same winner payloads."""
    payloads = {}
    for name, make, r in (("ours", make_store, rec(value=0.5, fresh=123.0)),
                          ("ref", ref_make_store, ref_rec(value=0.5, fresh=123.0))):
        path = str(tmp_path / f"{name}.{'sqlite' if kind == 'sqlite' else 'json'}")
        store = make(kind, path)
        store.put("add/v5e/seed=1|t_x=4", 0.5)
        store.put_winner(r.key, r.to_payload())
        store.save()
        if hasattr(store, "close"):
            store.close()
        reopened = make_store(kind, path)
        got = lookup_winner(reopened, "add", 8192, 8192, "v5e")
        assert (got.value, got.fresh, got.config) == (0.5, 123.0, {"t_x": 4})
        assert reopened.get("add/v5e/seed=1|t_x=4") == 0.5
        payloads[name] = dict(reopened.winner_items())
        if hasattr(reopened, "close"):
            reopened.close()
    assert payloads["ours"] == payloads["ref"]


def test_json_store_without_winners_keeps_legacy_format(tmp_path):
    path = str(tmp_path / "s.json")
    store = MeasurementStore(path)
    store.put("k", 1.0)
    store.save()
    assert "winners" not in json.load(open(path))
    store.put_winner("add|x=1|y=1|d", rec().to_payload())
    store.save()
    assert json.load(open(path))["__format__"] == 3


def test_record_winner_applies_merge_policy_in_store():
    for kind in ("json", "sqlite"):
        ours, ref = make_store(kind, None), ref_make_store(kind, None)
        for r in ({"value": 1.0, "fresh": 10.0}, {"value": 2.0, "fresh": 99.0}):
            record_winner(ours, rec(**r), save=False)
            ref_serving.record_winner(ref, ref_rec(**r), save=False)
        assert ours.get_winner(rec().key) == ref.get_winner(rec().key)
        kept = json.loads(ours.get_winner(rec().key))
        assert kept["value"] == 1.0 and kept["fresh"] == 99.0


def test_absorb_winners_merges():
    dst, src = make_store("json", None), make_store("sqlite", None)
    dst.put_winner("k|x=1|y=1|d", rec(value=2.0, fresh=1.0).to_payload())
    src.put_winner("k|x=1|y=1|d", rec(value=1.0, fresh=2.0).to_payload())
    src.put_winner("k|x=2|y=2|d", rec(x=2, y=2, value=3.0).to_payload())
    absorb_winners(dst, src)
    assert json.loads(dst.get_winner("k|x=1|y=1|d"))["value"] == 1.0
    assert len(dict(dst.winner_items())) == 2


def test_index_winners_counts_and_merges():
    dst, a, b = (make_store("json", None) for _ in range(3))
    a.put_winner("k|x=1|y=1|d", rec(value=2.0).to_payload())
    b.put_winner("k|x=1|y=1|d", rec(value=1.0).to_payload())
    assert index_winners(dst, a, save=False) == 1
    assert index_winners(dst, b, save=False) == 1
    assert json.loads(dst.get_winner("k|x=1|y=1|d"))["value"] == 1.0


# --------------------------------------------------- session -> winners index


def test_session_records_winner_transactionally(tmp_path):
    """The same matrix through both packages indexes the same winner (its
    wall-clock freshness stamp aside), pointing at a measurement its store
    holds."""
    session = TuningSession(SMOKE_SPEC.replace(store="json",
                                               store_path=str(tmp_path / "c.json")))
    session.run_matrix()
    store = MeasurementStore(str(tmp_path / "c.json"))
    got = lookup_winner(store, "add", 8192, 8192, "v5e")
    assert store.get(got.store_key) == got.value
    assert got.value == min(v for k, v in store.items() if "|final" in k)
    assert got.config == parse_config_from_store_key(got.store_key)
    assert got.fingerprint == session.journal_namespace()
    assert got.fresh > 0

    ref = RefSession(REF_SMOKE_SPEC.replace(store="json", store_path=str(tmp_path / "r.json")))
    ref.run_matrix()
    want = ref_serving.lookup_winner(ref_make_store("json", str(tmp_path / "r.json")),
                                     "add", 8192, 8192, "v5e")
    for name in ("kernel", "x", "y", "device", "config", "value", "fingerprint", "source",
                 "store_key"):
        assert getattr(got, name) == getattr(want, name), name


# ------------------------------------------------------------------- serving


def serve_store_with(records, make=make_store):
    store = make("json", None)
    for r in records:
        store.put_winner(r.key, r.to_payload())
    return store


def test_best_config_hit_stale_nearest_miss():
    records = [dict(x=8192, y=8192, value=1.0, fresh=1000.0),
               dict(x=1024, y=1024, value=2.0, fresh=1000.0)]
    ours = serve_store_with([rec(**r) for r in records])
    ref = serve_store_with([ref_rec(**r) for r in records], ref_make_store)
    queries = [(("add", 8192, 8192, "v5e"), dict(now=1010.0)),
               (("add", 8192, 8192, "v5e"), dict(max_age_s=5.0, now=1010.0)),
               (("add", 2048, 2048, "v5e"), {}),
               (("harris", 8192, 8192, "v5e"), {}), (("add", 8192, 8192, "v4"), {})]
    got = [best_config(ours, *q, **kw).to_dict() for q, kw in queries]
    assert got == [ref_serving.best_config(ref, *q, **kw).to_dict() for q, kw in queries]
    hit, stale, near, *misses = got
    assert (hit["status"], hit["value"], hit["age_s"]) == ("hit", 1.0, 10.0)
    assert hit["matched_key"] == "add|x=8192|y=8192|v5e"
    assert stale["status"] == "stale" and stale["config"] == hit["config"]
    assert near["status"] == "nearest" and near["matched_key"] == "add|x=1024|y=1024|v5e"
    assert [m["status"] for m in misses] == ["miss", "miss"]


def test_nearest_is_log_space_and_deterministic():
    store = serve_store_with([rec(x=4096, y=4096, value=1.0), rec(x=32768, y=32768, value=2.0)])
    assert nearest_winner(store, "add", 8192, 8192, "v5e").x == 4096


def test_miss_enqueues_idempotent_job(tmp_path):
    store = make_store("sqlite", str(tmp_path / "s.sqlite"))
    queue = JobQueue(store, "sqlite", str(tmp_path / "s.sqlite"), str(tmp_path / "q"))
    res = best_config(store, "add", 8192, 8192, "v5e", queue=queue)
    assert res.status == "miss" and res.job_id is not None
    assert best_config(store, "add", 8192, 8192, "v5e", queue=queue).job_id == res.job_id
    assert queue.depth() == 1
    job = queue.job(res.job_id)
    assert job["state"] == "pending" and job["spec"]["kernel"] == "add"
    store.close()
    # the reference enqueues the same cost-model job under the same id
    ref_store = ref_make_store("sqlite", str(tmp_path / "r.sqlite"))
    ref_q = ref_serving.JobQueue(ref_store, "sqlite", str(tmp_path / "r.sqlite"),
                                 str(tmp_path / "rq"))
    assert ref_serving.best_config(ref_store, "add", 8192, 8192, "v5e",
                                   queue=ref_q).job_id == res.job_id
    ref_store.close()


def test_default_miss_spec_backend_split():
    cm = default_miss_spec("add", 8192, 8192, "v4")
    assert cm.backend == "costmodel" and cm.backend_kwargs == {"chip": "v4"}
    assert cm.to_dict() == ref_serving.default_miss_spec("add", 8192, 8192, "v4").to_dict()
    card = default_miss_spec("mandelbrot", 8192, 8192, CARD)
    assert card.backend == "cuda" and card.backend_kwargs == {"x": 8192, "y": 8192}
    assert card.design == ExperimentDesign.smoke() and card.algorithms == ("rs", "ga")
    cpu = default_miss_spec("add", 512, 256, "cpu")
    assert cpu.backend == "cuda"
    assert cpu.backend_kwargs == {"x": 512, "y": 256, "device": "cpu"}


def test_serve_result_dict_shape():
    d = ServeResult(status="miss", kernel="k", x=1, y=2, device="d").to_dict()
    assert d == ref_serving.ServeResult(status="miss", kernel="k", x=1, y=2,
                                        device="d").to_dict()
    assert d["status"] == "miss" and d["config"] is None and d["job_id"] is None


# ---------------------------------------------------------------- the label


def test_cuda_winner_is_keyed_by_the_card_name(named_card):
    spec = TuningSpec(kernel="harris", backend="cuda", backend_kwargs={"x": 4096})
    assert spec_geometry(spec) == (4096, 8192, CARD)
    assert device_label("cuda:0") == CARD
    on_cpu = spec.replace(backend_kwargs={"x": 64, "y": 128, "device": "cpu"})
    assert spec_geometry(on_cpu) == (64, 128, "cpu")
    assert spec_geometry(SMOKE_SPEC)[2] == "v5e"


def test_a_card_that_cannot_be_named_indexes_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_label("cuda") is None
    assert spec_geometry(TuningSpec(kernel="harris", backend="cuda")) is None
    assert device_label("cpu") == "cpu"


def test_a_cuda_winner_answers_only_its_card(tmp_path, named_card):
    """A winner is keyed where it was measured: the card's winner is a hit
    for the card's name and never answers a cost-model chip or the CPU,
    not even as the nearest geometry."""
    store = make_store("json", None)
    record_winner(store, rec(kernel="harris", device=CARD, fresh=1.0), save=False)
    assert best_config(store, "harris", 8192, 8192, CARD).status == "hit"
    assert best_config(store, "harris", 4096, 4096, CARD).status == "nearest"
    for label in ("v5e", "cpu", "NVIDIA A100-SXM4-80GB"):
        assert best_config(store, "harris", 8192, 8192, label).status == "miss"


# ---------------------------------------------------------------------- http


def serve_in_thread(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server.server_address[:2]


def test_http_endpoint(tmp_path):
    """The same store and the same requests through the port's server and
    the reference's: the same answers (a hit's age aside, which is the
    wall clock)."""
    bodies = []
    for make, state_cls, make_srv, queue_cls, r in (
            (make_store, ServingState, make_server, JobQueue, rec(value=1.5, fresh=100.0)),
            (ref_make_store, RefServingState, ref_make_server, ref_serving.JobQueue,
             ref_rec(value=1.5, fresh=100.0))):
        store = make("json", None)
        store.put_winner(r.key, r.to_payload())
        queue = queue_cls(store, "json", str(tmp_path / f"{len(bodies)}.json"),
                          str(tmp_path / f"q{len(bodies)}"))
        server = make_srv(state_cls(store, queue=queue), port=0)
        host, port = serve_in_thread(server)
        try:
            def get(path, host=host, port=port):
                with urllib.request.urlopen(f"http://{host}:{port}{path}") as resp:
                    return resp.status, json.loads(resp.read())

            got = [get("/healthz"),
                   get("/best_config?kernel=add&x=8192&y=8192&device=v5e"),
                   get("/best_config?kernel=nope&x=4&y=4&device=v5e"),
                   get("/stats")]
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    f"http://{host}:{port}/best_config?kernel=add&x=nope&y=1&device=d")
            got.append(err.value.code)
            got[1][1].pop("age_s")
            bodies.append(got)
        finally:
            server.shutdown()
            server.server_close()
    assert bodies[0] == bodies[1]
    health, hit, miss, stats, bad = bodies[0]
    assert health == (200, {"ok": True})
    assert hit[1]["status"] == "hit" and hit[1]["value"] == 1.5
    assert miss[1]["status"] == "miss" and miss[1]["job_id"]
    assert stats[1]["winners"] == 1 and stats[1]["queue_depth"] == 1
    assert bad == 400


# -------------------------------------------------------- concurrent serving


HAMMER = r"""
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.core.stores import make_store
from repro_torch.serving import best_config
store = make_store("sqlite", sys.argv[2])
last_fresh = 0.0
for _ in range(120):
    res = best_config(store, "add", 8192, 8192, "v5e")
    if res.status != "hit":
        sys.exit(f"unexpected status {res.status}")
    if res.config["i"] != int(round(1000.0 - res.value)):
        sys.exit(f"torn read: value={res.value} config={res.config}")
    if res.fresh < last_fresh:
        sys.exit(f"freshness went backwards: {res.fresh} < {last_fresh}")
    last_fresh = res.fresh
store.close()
print("ok")
"""


def test_concurrent_readers_never_see_torn_winners(tmp_path):
    """Reader threads and two reader processes hammer ``best_config`` while
    a writer thread rewrites the winner through the merge policy: every
    record read is whole (value matches config) and each reader's observed
    freshness never goes back."""
    path = str(tmp_path / "serve.sqlite")
    seed_store = SqliteMeasurementStore(path, autosave_every=0)
    assert seed_store._conn.execute("PRAGMA journal_mode").fetchone()[0].lower() == "wal"
    assert seed_store._conn.execute("PRAGMA busy_timeout").fetchone()[0] == 5000

    def winner_at(i: int) -> WinnerRecord:
        return rec(value=1000.0 - i, config={"i": i})

    record_winner(seed_store, winner_at(0))
    seed_store.close()
    stop = threading.Event()
    errors: list[str] = []

    def writer():
        store = SqliteMeasurementStore(path, autosave_every=0)
        i = 0
        try:
            while not stop.is_set():
                i += 1
                record_winner(store, winner_at(i))
        finally:
            store.close()

    def reader():
        store = SqliteMeasurementStore(path)
        last_fresh = 0.0
        try:
            for _ in range(200):
                res = best_config(store, "add", 8192, 8192, "v5e")
                if res.status != "hit":
                    errors.append(f"status {res.status}")
                    return
                if res.config["i"] != int(round(1000.0 - res.value)):
                    errors.append(f"torn: {res.value} vs {res.config}")
                    return
                if res.fresh < last_fresh:
                    errors.append(f"fresh regressed {res.fresh}<{last_fresh}")
                    return
                last_fresh = res.fresh
        finally:
            store.close()

    wt = threading.Thread(target=writer)
    readers = [threading.Thread(target=reader) for _ in range(4)]
    procs = [subprocess.Popen([sys.executable, "-c", HAMMER, os.path.join(ROOT, "src"), path],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    wt.start()
    for r in readers:
        r.start()
    for r in readers:
        r.join(timeout=120)
    outs = [p.communicate(timeout=120)[0] for p in procs]
    stop.set()
    wt.join(timeout=120)
    assert errors == []
    for p, out in zip(procs, outs, strict=True):
        assert p.returncode == 0 and "ok" in out, out


# ------------------------------------------------------------------ JobQueue


def test_job_id_ignores_storage_fields():
    a = default_miss_spec("add", 8192, 8192, "v5e").to_dict()
    assert job_id_for_spec(a) == ref_serving.job_id_for_spec(
        ref_serving.default_miss_spec("add", 8192, 8192, "v5e").to_dict())
    b = dict(a, store="sqlite", store_path="/somewhere/else.sqlite")
    assert job_id_for_spec(a) == job_id_for_spec(b)
    assert job_id_for_spec(a) != job_id_for_spec(dict(a, kernel="harris"))
    card = default_miss_spec("add", 8192, 8192, CARD).to_dict()
    assert job_id_for_spec(card) not in (job_id_for_spec(a), job_id_for_spec(
        default_miss_spec("add", 8192, 8192, "cpu").to_dict()))


def test_unit_digest_is_the_references():
    units = build_units(TuningSession(SMOKE_SPEC.replace(algorithms=("rs", "ga"))).cells(),
                        min_units=8)
    assert len(units) >= 8
    assert [unit_digest(u.key) for u in units] == [ref_unit_digest(u.key) for u in units]


def queue_at(tmp_path, name="q") -> JobQueue:
    return JobQueue(make_store("json", None), "json", str(tmp_path / "s.json"),
                    str(tmp_path / name), claim_timeout_s=0.2)


def test_claim_is_exclusive_then_released(tmp_path):
    q = queue_at(tmp_path)
    assert q.claim_unit("j1", "rs/S25/E4/e0:4", "w1") == "fresh"
    assert q.claim_unit("j1", "rs/S25/E4/e0:4", "w2") is None
    assert q.unit_claimed("j1", "rs/S25/E4/e0:4")
    q.release_unit("j1", "rs/S25/E4/e0:4")
    assert q.claim_unit("j1", "rs/S25/E4/e0:4", "w2") == "fresh"
    # the claim file has the reference's name
    ref_q = ref_serving.JobQueue(ref_make_store("json", None), "json",
                                 str(tmp_path / "s.json"), str(tmp_path / "q"))
    assert q._claim_path("j1", "u") == ref_q._claim_path("j1", "u")


def test_stale_claim_is_stolen(tmp_path):
    q = queue_at(tmp_path)
    assert q.claim_unit("j1", "u", "victim") == "fresh"
    path = q._claim_path("j1", "u")
    old = time.time() - 60.0
    os.utime(path, (old, old))
    assert q.claim_unit("j1", "u", "peer") == "stolen"
    assert open(path).read() == "peer"


def test_heartbeat_prevents_steal(tmp_path):
    q = queue_at(tmp_path)
    q.claim_unit("j1", "u", "w1")
    path = q._claim_path("j1", "u")
    old = time.time() - 60.0
    os.utime(path, (old, old))
    q.heartbeat_unit("j1", "u")
    assert q.claim_unit("j1", "u", "peer") is None


def test_done_markers_are_atomic_json(tmp_path):
    q = queue_at(tmp_path)
    assert q.unit_done("j1", "u") is None
    q.write_unit_done("j1", "u", {"ident": "w1", "stolen": False})
    assert q.unit_done("j1", "u") == {"ident": "w1", "stolen": False}
    q.cleanup_job_files("j1")
    assert q.unit_done("j1", "u") is None
    assert not any(f.startswith("j1.") for f in os.listdir(q.qdir))


def test_mark_done_persists_through_store(tmp_path):
    path = str(tmp_path / "s.json")
    q = JobQueue(make_store("json", path), "json", path, str(tmp_path / "q"))
    jid = q.enqueue(SMOKE_SPEC)
    assert [j["id"] for j in q.pending_jobs()] == [jid]
    q.mark_done(jid, ident="collect")
    assert q.pending_jobs() == [] and q.job(jid)["state"] == "done"
    q2 = JobQueue(make_store("json", path), "json", path, str(tmp_path / "q"))
    assert q2.job(jid)["state"] == "done"


# ------------------------------------------------------------- fleet end2end


def fleet_fill(tmp_path, pkg, spec, label, name):
    """miss -> enqueue -> one fleet worker drains -> collect; returns the
    miss, the collected ids, the follow-up answer and the store's values."""
    path = str(tmp_path / f"{name}.sqlite")
    qdir = str(tmp_path / f"{name}_queue")
    store = pkg["make_store"]("sqlite", path)
    queue = pkg["JobQueue"](store, "sqlite", path, qdir)
    miss = pkg["best_config"](store, spec.kernel, 8192, 8192, label, queue=queue,
                              enqueue_spec=spec)
    store.close()
    assert pkg["FleetWorker"]("sqlite", path, qdir, ident="w1").drain(
        max_jobs=1, timeout_s=120.0) == 1
    collected = pkg["collect_jobs"]("sqlite", path, qdir)
    store = pkg["make_store"]("sqlite", path)
    hit = pkg["best_config"](store, spec.kernel, 8192, 8192, label)
    queue = pkg["JobQueue"](store, "sqlite", path, qdir)
    state = (queue.depth(), queue.job(miss.job_id)["state"])
    values = {k: v for k, v in store.items() if not k.startswith("__")}
    store.close()
    return miss, collected, hit, state, values


PORT = dict(make_store=make_store, JobQueue=JobQueue, best_config=best_config,
            FleetWorker=FleetWorker, collect_jobs=collect_jobs)
REF = dict(make_store=ref_make_store, JobQueue=ref_serving.JobQueue,
           best_config=ref_serving.best_config, FleetWorker=ref_serving.FleetWorker,
           collect_jobs=ref_serving.collect_jobs)


def test_fleet_fills_a_miss_end_to_end(tmp_path):
    """The port's fleet fills the cost-model miss with the store values of
    the reference's fleet run and of the port's serial run, byte for byte,
    under the reference's job id; the follow-up query is a hit."""
    miss, collected, hit, state, values = fleet_fill(tmp_path, PORT, SMOKE_SPEC, "v5e", "ours")
    assert miss.status == "miss" and collected == [miss.job_id]
    assert hit.status == "hit" and hit.fingerprint
    assert state == (0, "done")
    r_miss, r_collected, r_hit, _, r_values = fleet_fill(tmp_path, REF, REF_SMOKE_SPEC, "v5e",
                                                         "ref")
    assert r_miss.job_id == miss.job_id and r_collected == collected
    assert json.dumps(sorted(values.items())) == json.dumps(sorted(r_values.items()))
    assert (hit.config, hit.value, hit.fingerprint) == (r_hit.config, r_hit.value,
                                                         r_hit.fingerprint)
    serial = TuningSession(SMOKE_SPEC.replace(store="json",
                                              store_path=str(tmp_path / "serial.json")))
    serial.run_matrix()
    assert values == dict(MeasurementStore(str(tmp_path / "serial.json")).items())


def test_fleet_fills_a_cuda_miss_with_the_plain_versions(tmp_path):
    """A ``device="cpu"`` cuda job: the worker runs the plain versions, the
    winner is keyed ``cpu`` at the job's geometry, and the store equals the
    serial run's."""
    spec = CPU_JOB
    path, qdir = str(tmp_path / "serve.sqlite"), str(tmp_path / "queue")
    with ticking_clock():
        store = make_store("sqlite", path)
        queue = JobQueue(store, "sqlite", path, qdir)
        miss = best_config(store, "mandelbrot", 64, 128, "cpu", queue=queue,
                           enqueue_spec=spec)
        store.close()
        assert miss.status == "miss"
        assert FleetWorker("sqlite", path, qdir, ident="w1").drain(max_jobs=1) == 1
        assert collect_jobs("sqlite", path, qdir) == [miss.job_id]
        serial = TuningSession(spec.replace(store="json",
                                            store_path=str(tmp_path / "serial.json")))
        serial.run_matrix()
    store = make_store("sqlite", path)
    hit = best_config(store, "mandelbrot", 64, 128, "cpu")
    assert hit.status == "hit" and hit.matched_key == "mandelbrot|x=64|y=128|cpu"
    values = {k: v for k, v in store.items() if not k.startswith("__")}
    store.close()
    assert json.dumps(sorted(values.items())) == json.dumps(
        sorted(MeasurementStore(str(tmp_path / "serial.json")).items()))
    assert lookup_winner(make_store("json", serial.spec.store_path), "mandelbrot", 64, 128,
                         "cpu").config == hit.config


#: a CPU job of both of the service's algorithms, several units a job
TWO_ALGO_JOB = CPU_JOB.replace(algorithms=("rs", "ga"), design=ExperimentDesign(
    sample_sizes=(6, 8), n_experiments=(2, 1), final_repeats=2))


def traced_fill(tmp_path, spec, telemetry, name="fill"):
    """The owner's miss, one in-process worker's drain, collect and the
    owner's second query, all through one sink; returns the two answers,
    the collected ids and the store's measurement items."""
    path, qdir = str(tmp_path / f"{name}.sqlite"), str(tmp_path / f"{name}_queue")
    store = make_store("sqlite", path)
    queue = JobQueue(store, "sqlite", path, qdir, telemetry=telemetry)
    kernel, x, y = spec.kernel, spec.backend_kwargs["x"], spec.backend_kwargs["y"]
    miss = best_config(store, kernel, x, y, "cpu", queue=queue, enqueue_spec=spec,
                       telemetry=telemetry)
    assert FleetWorker("sqlite", path, qdir, ident="w1", telemetry=telemetry).drain() == 1
    collected = collect_jobs("sqlite", path, qdir, telemetry=telemetry)
    hit = best_config(store, kernel, x, y, "cpu", telemetry=telemetry)
    items = dict(store.items())
    store.close()
    return miss, hit, collected, items


def plain_scan(items: dict, cache_key: str):
    """The least finite ``|final`` value under the job's cache key, ties on
    key, and its config: a Python scan, apart from the store's SQL and the
    winners index."""
    key, value = min(((k, v) for k, v in items.items()
                      if k.startswith(f"{cache_key}/") and "|final" in k and v < float("inf")),
                     key=lambda kv: (kv[1], kv[0]))
    pairs = key[len(cache_key):].split("|")[1].split(",")
    return {k: int(v) for k, v in (p.split("=") for p in pairs)}, value


def test_a_traced_fill_has_fleet_and_serve_stages(tmp_path):
    """The worker's own work is ``fleet`` stages (its sessions for the job
    seeded, claims, journal lookups, done markers) and its shard session's
    record of each unit (the journal's put, the store's save) ``session``
    stages, the owner's ``serve`` stages (the miss, collect, the hit);
    every stage interval of the trace is disjoint from every other, and
    none falls inside a unit the worker ran."""
    from repro_torch.telemetry import Telemetry, read_events
    from repro_torch.telemetry.events import PIPELINE_STAGES

    path = str(tmp_path / "trace.jsonl")
    with ticking_clock():
        tel = Telemetry(path)
        miss, hit, collected, _ = traced_fill(tmp_path, TWO_ALGO_JOB, tel)
        tel.close()
    assert miss.status == "miss" and collected == [miss.job_id] and hit.status == "hit"
    events = read_events(path)
    stages = [e for e in events if e["ev"] == "stage"]
    fleet = [e for e in stages if e["stage"] == "fleet"]
    serve = [e for e in stages if e["stage"] == "serve"]
    units = [e for e in events if e["ev"] == "end" and e.get("span") == "fleet_unit"]
    assert len(units) == len({e["unit"] for e in units}) >= 3
    session = [e for e in stages if e["stage"] == "session"]
    assert {e["part"] for e in fleet} == {"seed", "claim", "journal", "done"}
    assert {e["ident"] for e in fleet + session} == {"w1"}
    assert {e["job"] for e in fleet} == {miss.job_id, None}
    assert [e["job"] for e in fleet if e["part"] == "seed"] == [miss.job_id]
    # each unit's journal lookup before it runs; its put and store save
    # after; the shard stores' last save and close when the drain ends
    assert [e["job"] for e in fleet if e["part"] == "journal"] == [miss.job_id] * len(units)
    assert [(e["part"], e["job"]) for e in session] == (
        [("record", miss.job_id)] * len(units) + [("record", None)])
    assert [(e["part"], e.get("status"), e.get("jobs")) for e in serve] == [
        ("query", "miss", None), ("collect", None, 1), ("query", "hit", None)]

    def interval(e):
        return e["t"] - e["dur"], e["t"]

    spans = sorted(interval(e) for e in stages)
    for (s0, e0), (s1, e1) in zip(spans, spans[1:]):
        assert e0 <= s1, ((s0, e0), (s1, e1))
    for e in fleet + serve + session:
        a0, a1 = interval(e)
        for u in units:
            b0, b1 = interval(u)
            assert a1 <= b0 or b1 <= a0, (e, u)
    measured = [e for e in stages if e["stage"] in PIPELINE_STAGES]
    assert measured and all(any(interval(u)[0] <= interval(e)[0] and interval(e)[1]
                                <= interval(u)[1] for u in units) for e in measured)


def test_a_fill_serves_the_serial_runs_winner_and_the_plain_scan(tmp_path):
    """The fleet's served config and value are the winner a serial
    ``run_matrix`` of the same spec indexes, and the plain scan's answer
    over the fleet's store."""
    with ticking_clock():
        miss, hit, _, items = traced_fill(tmp_path, TWO_ALGO_JOB, None)
        serial = TuningSession(TWO_ALGO_JOB.replace(
            store="json", store_path=str(tmp_path / "serial.json")))
        serial.run_matrix()
    rec = lookup_winner(make_store("json", serial.spec.store_path), TWO_ALGO_JOB.kernel,
                        64, 128, "cpu")
    assert (hit.config, hit.value) == (rec.config, rec.value)
    assert (hit.config, hit.value) == plain_scan(items, serial.cache_key)
    assert hit.matched_key == rec.key and hit.fingerprint == rec.fingerprint


def test_an_untraced_fill_reads_no_clock_for_its_stages(tmp_path, monkeypatch):
    """With the null sink the fleet and the serve stages build nothing and
    read no clock, and the fill's store values are the traced fill's."""
    from repro_torch.serving import api as serve_api
    from repro_torch.serving import fleet as serve_fleet
    from repro_torch.telemetry import Telemetry
    from repro_torch.telemetry.null import NullTelemetry

    def no_read():
        raise AssertionError("a stage read the clock with the sink off")

    built = []
    monkeypatch.setattr(serve_api, "monotonic", no_read)
    monkeypatch.setattr(serve_fleet, "monotonic", no_read)
    monkeypatch.setattr(NullTelemetry, "stage",
                        lambda self, name, dur, **attrs: built.append(name))
    with ticking_clock():
        miss, hit, _, off = traced_fill(tmp_path, TWO_ALGO_JOB, None, "off")
    assert hit.status == "hit" and built == []
    monkeypatch.undo()
    with ticking_clock():
        tel = Telemetry(str(tmp_path / "on.jsonl"))
        _, hit_on, _, on = traced_fill(tmp_path, TWO_ALGO_JOB, tel, "on")
        tel.close()
    values = {k: v for k, v in off.items() if not k.startswith("__")}
    assert values and values == {k: v for k, v in on.items() if not k.startswith("__")}
    assert (hit.config, hit.value) == (hit_on.config, hit_on.value)


def test_worker_raises_on_a_cuda_job_without_a_card(tmp_path):
    """The worker CLI in a process of its own: a job on the card, on a host
    with none, fails with the cause — it never runs the plain versions in
    the card's place — and leaves the job pending and unclaimed."""
    d = str(tmp_path / "serve")
    assert serving_cli(["enqueue", "--dir", d, "--kernel", "mandelbrot", "--x", "64",
                        "--y", "128", "--device", CARD]) == 0
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "repro_torch.serving", "worker", "--dir", d,
                          "--max-jobs", "1"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "job(s) completed" not in out.stdout
    store = make_store("sqlite", os.path.join(d, "store.sqlite"))
    queue = JobQueue(store, "sqlite", os.path.join(d, "store.sqlite"), os.path.join(d, "queue"))
    assert queue.depth() == 1
    assert [f for f in os.listdir(queue.qdir) if f.endswith(".claim")] == []
    assert not [k for k, _ in store.items() if not k.startswith("__")]
    store.close()


def test_cli_index_query_worker_collect_replay(tmp_path, capsys):
    """The command line end to end on the CPU (clock ticking 1.0 a reading):
    a tuned store indexed, a hit, a nearest, a miss; a job queued for it
    filled by a worker, collected, then a hit; the job replayed serially
    into a store with the same values; the serving counters in the trace
    match the queries made."""
    from repro_torch.telemetry.assert_counters import main as assert_counters

    d = str(tmp_path / "serve")
    q = ["--dir", d, "--telemetry"]

    def query(kernel, x, y, *extra):
        assert serving_cli(["query", *q, "--kernel", kernel, "--x", str(x), "--y", str(y),
                            "--device", "cpu", *extra]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    with ticking_clock():
        tuned = str(tmp_path / "tuned.json")
        TuningSession(CPU_JOB.replace(kernel="harris", store="json", store_path=tuned)
                      ).run_matrix()
        assert serving_cli(["index", "--dir", d, tuned]) == 0
        assert "winners index <- 1 record(s)" in capsys.readouterr().out
        assert query("harris", 64, 128, "--expect", "hit")["status"] == "hit"
        assert query("harris", 128, 128)["status"] == "nearest"
        assert query("mandelbrot", 64, 128)["status"] == "miss"
        store_path = os.path.join(d, "store.sqlite")
        store = make_store("sqlite", store_path)
        jid = JobQueue(store, "sqlite", store_path, os.path.join(d, "queue")).enqueue(CPU_JOB)
        store.close()
        assert serving_cli(["jobs", "--dir", d]) == 0
        assert json.loads(capsys.readouterr().out) == {"id": jid, "kernel": "mandelbrot",
                                                        "state": "pending"}
        assert serving_cli(["worker", *q, "--max-jobs", "1"]) == 0
        assert "1 job(s) completed" in capsys.readouterr().out
        assert serving_cli(["collect", *q]) == 0
        assert jid in capsys.readouterr().out
        assert query("mandelbrot", 64, 128, "--expect", "hit")["status"] == "hit"
        replay = str(tmp_path / "replay.json")
        assert serving_cli(["replay", "--dir", d, "--job", jid, "--out", replay]) == 0
    assert assert_counters([d, "serve.hits==2", "serve.nearest==1", "serve.misses==1",
                            "fleet.jobs_completed==1", "fleet.jobs_collected==1"]) == 0
    store = make_store("sqlite", store_path)
    served = {k: v for k, v in store.items() if k.startswith("mandelbrot/")}
    store.close()
    assert json.dumps(sorted(served.items())) == json.dumps(
        sorted(MeasurementStore(replay).items()))


def test_http_serve_command_answers_as_the_query_does(tmp_path, capsys):
    """``serve`` in a process of its own: ``GET /best_config`` gives the
    query's JSON (its timing and the hit's age aside)."""
    import socket

    tuned = str(tmp_path / "tuned.json")
    TuningSession(CPU_JOB.replace(kernel="harris", store="json", store_path=tuned)
                  ).run_matrix()
    d = str(tmp_path / "serve")
    assert serving_cli(["index", "--dir", d, tuned]) == 0
    assert serving_cli(["query", "--dir", d, "--kernel", "harris", "--x", "64", "--y", "128",
                        "--device", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.serving", "serve", "--dir", d,
                             "--port", str(port)], stdout=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    try:
        assert "http://" in proc.stdout.readline()
        qs = urllib.parse.urlencode(dict(kernel="harris", x=64, y=128, device="cpu"))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/best_config?{qs}") as resp:
            got = json.loads(resp.read())
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    for d_ in (got, want):
        d_.pop("age_s")
        d_.pop("serve_ms", None)
    assert got == want and got["status"] == "hit"


# --------------------------------------------------------- staticcheck knobs


def test_staticcheck_sets_cover_serving_knobs():
    """The serving layer's pacing/plumbing knobs are registered with the
    port's static gate: PROV001 guards fleet pacing out of provenance,
    OBS001 keeps serve-dir plumbing out of identity sinks — the reference's
    sets, entry for entry, but for the two knobs of the reference's
    measurement that the port does not have."""
    from repro.staticcheck.obs import TELEMETRY_TOKENS as REF_TOKENS
    from repro.staticcheck.prov import SINK_NAMES as REF_SINKS
    from repro.staticcheck.prov import SPEED_KNOBS as REF_KNOBS
    from repro_torch.staticcheck.obs import TELEMETRY_TOKENS
    from repro_torch.staticcheck.prov import SINK_NAMES, SPEED_KNOBS

    assert {"claim_timeout_s", "poll_s", "stall_s"} <= set(SPEED_KNOBS)
    assert {"serve_dir", "qdir", "queue_dir"} <= set(TELEMETRY_TOKENS)
    ref_knobs = tuple(k for k in REF_KNOBS if k not in ("pipeline_workers", "compile_cache"))
    assert len(ref_knobs) == len(REF_KNOBS) - 2
    assert (SPEED_KNOBS, TELEMETRY_TOKENS, SINK_NAMES) == (ref_knobs, REF_TOKENS, REF_SINKS)
