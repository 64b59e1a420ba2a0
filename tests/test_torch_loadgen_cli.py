"""The port's loadgen CLI (production_stack_tpu_torch/loadgen/__main__.py)
against the JAX package's: the same subcommands, each with the same
options and defaults, the same argv parsing to the same namespaces and
the same duration parser. The one difference is --platform, the
engines' --device: default "cuda", choices "cuda" and "cpu".
"""

import argparse

import pytest

from production_stack_tpu.loadgen import __main__ as jcli
from production_stack_tpu_torch.loadgen import __main__ as tcli


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


JSUB = _subparsers(jcli.build_parser())
TSUB = _subparsers(tcli.build_parser())
COMMANDS = sorted(JSUB)


def _option(action):
    """What an option is, its help and type named (the two packages' type
    functions are different objects with the same name)."""
    return dict(option_strings=action.option_strings, dest=action.dest,
                default=action.default, nargs=action.nargs,
                const=action.const, required=action.required,
                choices=action.choices, help=action.help,
                type=getattr(action.type, "__name__", action.type),
                kind=type(action).__name__)


def _options(sp):
    return {a.dest: _option(a) for a in sp._actions}


def test_same_subcommands():
    assert sorted(TSUB) == COMMANDS
    assert len(COMMANDS) == 18
    assert tcli.build_parser().prog == \
        "python -m production_stack_tpu_torch.loadgen"


@pytest.mark.parametrize("cmd", COMMANDS)
def test_subcommand_options_equal_jax_but_platform(cmd):
    want, got = _options(JSUB[cmd]), _options(TSUB[cmd])
    assert sorted(got) == sorted(want)
    for dest in want:
        if dest == "platform":
            continue
        assert got[dest] == want[dest], dest
    assert [a.option_strings for a in TSUB[cmd]._actions] == \
        [a.option_strings for a in JSUB[cmd]._actions]
    assert TSUB[cmd]._defaults["fn"].__name__ == \
        JSUB[cmd]._defaults["fn"].__name__
    assert TSUB[cmd]._defaults["fn"].__module__ == \
        "production_stack_tpu_torch.loadgen.__main__"


@pytest.mark.parametrize("cmd", [c for c in COMMANDS
                                 if "platform" in _options(JSUB[c])])
def test_platform_is_the_card_by_default(cmd):
    opt = _options(TSUB[cmd])["platform"]
    assert opt["default"] == "cuda"
    assert opt["choices"] == ["cuda", "cpu"]
    assert _options(JSUB[cmd])["platform"]["default"] == "cpu"


def test_every_engine_subcommand_takes_platform():
    # run and soak drive a running stack and launch no engine
    assert sorted(c for c in COMMANDS
                  if "platform" not in _options(TSUB[c])) == ["run", "soak"]


def _required(cmd):
    return ["--base-url", "http://127.0.0.1:1"] if cmd in ("run", "soak") \
        else []


def _namespace(parser, argv):
    ns = vars(parser.parse_args(argv))
    fn = ns.pop("fn")
    return fn.__name__, ns


ARGVS = [[cmd, *_required(cmd)] for cmd in COMMANDS] + [
    ["run", "--base-url", "http://x", "--workload", "mixed", "--users",
     "4", "--seed", "3"],
    ["soak", "--base-url", "http://x", "--duration", "5m"],
    ["disagg", "--engine", "llama-3-8b", "--prefill-engines", "1",
     "--decode-engines", "1", "--chat-users", "3", "--rag-users", "2",
     "--duration", "10", "--chat-prompt-chars", "64", "--chat-tokens",
     "24", "--rag-prompt-chars", "700", "--rag-tokens", "4",
     "--min-prompt-chars", "256", "--kill-downtime", "2",
     "--min-itl-improvement", "-1", "--output", "d.json", "--log-dir",
     "logs"],
    ["disagg", "--no-split", "--no-prefill-kill", "--platform", "cpu"],
    ["kvshare", "--engine", "fake", "--sessions", "6", "--no-cache",
     "--platform", "cpu"],
    ["chaos", "--duration", "1m", "--router-kill", "--router-replicas",
     "3"],
    ["firedrill", "--scenarios", "engine_down", "--platform", "cpu"],
    ["effwatch", "--ab", "--duration", "90s", "--platform", "cpu"],
    ["distload", "--workers", "2", "--no-capstone", "--platform", "cpu"],
    ["trace", "--disagg", "--duration", "20", "--platform", "cpu"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a[:3]))
def test_same_argv_same_namespace(argv):
    jname, jns = _namespace(jcli.build_parser(), argv)
    tname, tns = _namespace(tcli.build_parser(), argv)
    assert tname == jname
    jplat, tplat = jns.pop("platform", None), tns.pop("platform", None)
    assert tns == jns
    if "--platform" in argv:
        assert tplat == jplat == "cpu"
    elif jplat is not None:
        assert (jplat, tplat) == ("cpu", "cuda")


@pytest.mark.parametrize("text", ["120", "120s", "5m", "4.4h", " 7 s ",
                                  "0.5m", "soon", "", "5d", "-3"])
def test_parse_duration_equal_jax(text):
    def outcome(fn):
        try:
            return fn(text)
        except argparse.ArgumentTypeError as e:
            return ("refused", str(e))
    assert outcome(tcli.parse_duration) == outcome(jcli.parse_duration)


@pytest.mark.parametrize("cmd", [c for c in COMMANDS
                                 if c not in ("run", "soak")])
def test_platform_tpu_refused(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.build_parser().parse_args([cmd, "--platform", "tpu"])
    assert e.value.code == 2
    assert "invalid choice: 'tpu'" in capsys.readouterr().err
