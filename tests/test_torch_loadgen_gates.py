"""The port's loadgen contracts against the JAX package's: every
``*_violations`` function gives the same list (or raises the same
error) on the same record, and the pure helpers give the same answers.

Two sources of records:
- the JAX package's own contract units: each is run as it stands, with
  the JAX function it tests wrapped to keep every record it is given
  (the clean one and each mutation the unit builds), and each kept
  record then goes through the port's function;
- the JAX package's committed records (``*_r*.json`` at the repo root):
  each clean, then once for every leaf of the record changed (numbers
  to 0, to -1 and grown, flags flipped, lists emptied), through both.
"""

import copy
import importlib
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules(name):
    return (importlib.import_module(f"production_stack_tpu.loadgen.{name}"),
            importlib.import_module(
                f"production_stack_tpu_torch.loadgen.{name}"))


def _outcome(fn, args, kwargs):
    try:
        return ("returned", fn(*args, **kwargs))
    except Exception as e:          # the same failure on both sides
        return ("raised", type(e).__name__, str(e))


# ------------------------------------------------- the JAX contract units

# (JAX test module, its unit, the loadgen module, the functions it calls)
UNITS = [
    ("test_loadgen_effwatch", t, "effwatch",
     ("effwatch_violations", "effwatch_ab_violations"))
    for t in ("test_violations_clean_record_passes",
              "test_violations_catch_each_gate",
              "test_ab_violations_clean_and_each_gate")
] + [
    ("test_loadgen_firedrill", t, "firedrill",
     ("firedrill_violations", "drill_slo_config"))
    for t in ("test_drill_slo_config_shape",
              "test_violations_clean_record_passes",
              "test_violations_catch_each_contract")
] + [
    ("test_loadgen_incident", t, "incident",
     ("incident_violations", "bundle_completeness"))
    for t in ("test_violations_clean_record_passes",
              "test_violations_catch_each_contract",
              "test_bundle_completeness_unit")
] + [
    ("test_loadgen_kvmigrate", t, "kvmigrate", ("kvmigrate_violations",))
    for t in ("test_violations_pass_on_healthy_record",
              "test_violations_migration_did_not_recover",
              "test_violations_require_planner_moves",
              "test_violations_anti_vacuity_off_phase_must_fail",
              "test_violations_aggregate_blocks_must_be_conserved",
              "test_violations_storm_client_errors",
              "test_violations_no_alloc_attempts_is_vacuous",
              "test_violations_capacity_ratio_floor",
              "test_violations_raw_ratio_sanity_band",
              "test_violations_unmeasured_capacity_ratio",
              "test_violations_compressed_ttft_tolerance",
              "test_violations_codec_hit_rate_floor")
] + [
    ("test_loadgen_distributed", t, "distributed.distload",
     ("distload_violations",))
    for t in ("test_distload_violations_clean_record_passes",
              "test_distload_violations_catch_each_gate")
] + [
    ("test_loadgen_disagg", "test_real_engine_prompts_clamped_to_model_len",
     "disagg", ("clamp_storm_for_real_engine",)),
    ("test_loadgen_overhead", "test_overhead_payload_is_stable_bytes",
     "overhead", ("overhead_payload",)),
]


@pytest.mark.parametrize("unit", UNITS, ids=lambda u: f"{u[0][5:]}-{u[1]}")
def test_jax_contract_units_equal_on_the_port(unit, monkeypatch):
    test_module, test_name, module, names = unit
    jmod, tmod = _modules(module)
    tests = importlib.import_module(f"tests.{test_module}")
    calls = []
    for name in names:
        orig = getattr(jmod, name)

        def kept(*args, _orig=orig, _name=name, **kwargs):
            snap = copy.deepcopy((args, kwargs))
            out = _orig(*args, **kwargs)
            calls.append((_name, snap, out))
            return out
        monkeypatch.setattr(jmod, name, kept)
        if hasattr(tests, name):
            monkeypatch.setattr(tests, name, kept)
    getattr(tests, test_name)()
    assert calls, f"{test_name} called none of {names}"
    for name, (args, kwargs), want in calls:
        assert _outcome(getattr(tmod, name), *copy.deepcopy(
            (args, kwargs))) == \
            ("returned", want), (name, args, kwargs)


# ---------------------------------------------- the committed records

RECORDS = [
    ("CHAOS_r08.json", "chaos", "chaos_violations", {}),
    ("DISAGG_r12.json", "disagg", "disagg_violations", {}),
    ("DISAGG_r12.json", "disagg", "disagg_violations",
     {"min_itl_improvement": None}),
    ("DISTLOAD_r22.json", "distributed.distload", "distload_violations",
     {}),
    ("EFF_r15.json", "effwatch", "effwatch_violations", {}),
    ("EFF_r17.json", "effwatch", "effwatch_ab_violations", {}),
    ("FIREDRILL_r14.json", "firedrill", "firedrill_violations", {}),
    ("FLEETDRILL_r20.json", "fleetdrill", "fleetdrill_violations", {}),
    ("INCIDENT_r18.json", "incident", "incident_violations", {}),
    ("KVMIGRATE_r19.json", "kvmigrate", "kvmigrate_violations", {}),
    ("KVSHARE_r11.json", "kvshare", "kvshare_violations", {}),
    ("KVSHARE_r11_fake.json", "kvshare", "kvshare_violations", {}),
    ("MULTIROUTER_r16.json", "multirouter", "multirouter_violations", {}),
    ("TENANT_r21.json", "multitenant", "multitenant_violations", {}),
    ("TRACE_r13.json", "trace", "trace_violations", {}),
]


def _leaves(node, path=()):
    """Every leaf's (path, value); a list of records (a ring, a series)
    is one leaf, and so are its first two and last entries' leaves."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(node, list) and node and \
            all(isinstance(v, (dict, list)) for v in node):
        yield path, node
        for i in sorted({0, 1, len(node) - 1} & set(range(len(node)))):
            yield from _leaves(node[i], path + (i,))
    else:
        yield path, node


def _mutations(record):
    """(path, value) pairs: each changes one leaf of the record."""
    for path, value in _leaves(record):
        if not path:
            continue
        if isinstance(value, bool):
            yield path, not value
        elif isinstance(value, (int, float)):
            yield from ((path, v) for v in (0, -1, value * 10 + 1))
        elif isinstance(value, list):
            if value:
                yield path, []
        elif value is None:
            yield path, 1


def _get(record, path):
    for k in path:
        record = record[k]
    return record


@pytest.mark.parametrize("case", RECORDS,
                         ids=lambda c: f"{c[0]}-{c[2]}-{len(c[3])}")
def test_committed_records_and_their_mutations_equal(case):
    fname, module, name, kwargs = case
    jmod, tmod = _modules(module)
    jfn, tfn = getattr(jmod, name), getattr(tmod, name)
    with open(os.path.join(REPO, fname)) as f:
        clean = json.load(f)
    assert _outcome(jfn, (clean,), kwargs) == ("returned", [])
    assert _outcome(tfn, (clean,), kwargs) == ("returned", [])
    seen = set()
    n = 0
    rec = copy.deepcopy(clean)
    for path, value in _mutations(clean):
        node = rec
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
        text = json.dumps(rec)
        node[path[-1]] = copy.deepcopy(_get(clean, path))
        # each side gets a record of its own
        want = _outcome(jfn, (json.loads(text),), kwargs)
        assert _outcome(tfn, (json.loads(text),), kwargs) == want, \
            (path, value)
        if want[0] == "returned":
            seen.update(want[1])
        n += 1
    assert n > 20
    # the mutations trip gates, not just the record's shape
    assert seen, f"no mutation of {fname} tripped a {name} gate"


# ------------------------------------------------------ the pure helpers

@pytest.mark.parametrize("chars", [(96, 2400), (64, 700), (701, 699),
                                   (5000, 100)])
def test_clamp_storm_for_real_engine_equal(chars):
    jmod, tmod = _modules("disagg")
    chat, rag = chars
    want = {"chat_prompt_chars": chat, "rag_prompt_chars": rag, "x": 1}
    got = dict(want)
    assert tmod.clamp_storm_for_real_engine(got) is got
    assert got == jmod.clamp_storm_for_real_engine(want)
    assert tmod.REAL_ENGINE_PROMPT_CHARS == jmod.REAL_ENGINE_PROMPT_CHARS
    assert tmod.REAL_KV_CHUNK_TOKENS == jmod.REAL_KV_CHUNK_TOKENS


@pytest.mark.parametrize("kw", [dict(), dict(num_tokens=4, stream=True),
                                dict(prompt_chars=256),
                                dict(prompt_chars=7, num_tokens=1)])
def test_overhead_payloads_equal(kw):
    jmod, tmod = _modules("overhead")
    small = {k: v for k, v in kw.items() if k != "prompt_chars"}
    assert tmod.overhead_payload("m", **small) == \
        jmod.overhead_payload("m", **small)
    jmake, tmake = (jmod.unique_payload_factory("m", **kw),
                    tmod.unique_payload_factory("m", **kw))
    assert [tmake() for _ in range(5)] == [jmake() for _ in range(5)]


@pytest.mark.parametrize("kw", [dict(window_scale=0.01),
                                dict(window_scale=1.0, min_events=10,
                                     ttft_threshold_s=2.0),
                                dict(window_scale=0.005, min_events=1)])
def test_drill_slo_config_equal(kw):
    jmod, tmod = _modules("firedrill")
    scale = kw.pop("window_scale")
    assert tmod.drill_slo_config(scale, **kw) == \
        jmod.drill_slo_config(scale, **kw)
    assert tmod.SCENARIO_NAMES == jmod.SCENARIO_NAMES


def test_bundle_completeness_equal():
    jmod, tmod = _modules("incident")
    expected = {"http://r1": "router", "http://e1": "engine",
                "http://o1": "obsplane"}
    full = {"fleet": {"processes": {
        "http://r1": {"health": {"status": "ok"}, "alerts": {}},
        "http://e1": {"load": {}, "perf": {}},
        "http://o1": {"health": {}}}}}
    variants = [full]
    for url, proc in full["fleet"]["processes"].items():
        for key in proc:
            b = copy.deepcopy(full)
            b["fleet"]["processes"][url][key] = None
            variants.append(b)
        b = copy.deepcopy(full)
        del b["fleet"]["processes"][url]
        variants.append(b)
        b = copy.deepcopy(full)
        b["fleet"]["processes"][url]["state"] = "unreachable"
        variants.append(b)
    variants.append({"fleet": {"processes": {}}})
    for b in variants:
        assert _outcome(tmod.bundle_completeness,
                        copy.deepcopy((b, expected)), {}) == \
            _outcome(jmod.bundle_completeness, (b, expected), {})
    assert tmod.SCENARIO_NAMES == jmod.SCENARIO_NAMES
