"""The torch port's ``--crop W:H[:X:Y]`` language against the JAX
package's: ``eval_ffmpeg_expr``, ``validate_crop_spec``,
``parse_crop_rect`` and the CLI's ``_validated_crop`` give the same
values, or raise the same exception types with the same messages, on
every case of the JAX package's own CLI tests and on generated
expressions and specs."""

import importlib
import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from video_annotator_tpu import cli as jcli
from video_annotator_tpu_torch import cli as tcli
from video_annotator_tpu_torch.pipeline import render as trender

# The module: the JAX pipeline package re-exports the function render().
jrender = importlib.import_module("video_annotator_tpu.pipeline.render")

ENV = {"iw": 192.0, "ih": 144.0, "x": 1.0}

EXPRESSIONS = [
    "2+3*4", "-(2+1)*4", "if(gt(iw,100),10,20)", "1+", "foo(2)", "(1", "1)2", "nope",
    "1;2", "1/0", "0/0", "100*pow(10,400)", "2^3", "2^3^2", "2*3^2", "1e3+2.5E-1",
    "mod(-5,3)", "mod(5,-3)", "round(2.5)", "round(-2.5)", "-3^2", "2^-3", "3^-2^2",
    "mod(1,0)", "floor(1/0)", "--3", "- -3", "--3^2", "2^--3", "4*--3", "---3", "--x",
    "--(1+2)", "min(1)", "if(1,2,3,4)", "abs(-iw)", "trunc(-2.5)", "ceil(0.1)",
    "lte(ih,iw)+gte(1,1)+lt(2,1)+eq(3,3)", "pow(-8,1/3)", "pow(0,-1)", "1e", "2E+3",
    ".5*iw", "max(iw,ih,x)", "  ( iw - 100 ) / 2 ", "",
]

CROP_RECTS = [
    ("100:80", 192, 144), ("101:81:3:5", 192, 144), ("in_w-100:in_h-44", 192, 144),
    ("iw/2:ih/2", 192, 144), ("min(iw,ih):min(iw,ih)", 192, 144),
    ("100:80:(in_w-out_w)/2:(in_h-out_h)/2", 192, 144), ("oh:ih/2", 192, 144),
    ("100/(ih-144)+100:80", 192, 144), ("100:80:y:10", 192, 144),
    ("100:80::10", 192, 144), ("100:80:", 192, 144), ("100:80:0:0:0:0", 192, 144),
    ("100:80:0:0:1", 192, 144), ("1:2:3:4:5:6:7", 192, 144),
    ("100:80:0:0:gt(2,1)", 192, 144), ("100:80:0:0:gt(iw,0)", 192, 144),
    ("iw/2:ih/2:(iw-ow)/2:(ih-oh)/2", 3840, 2880), ("iw/2:ih/2:(iw-ow)/2:(ih-oh)/2", 4680, 3520),
    ("x:10", 192, 144), ("300:300:-7:-9", 192, 144), ("1:1", 192, 144), (":", 192, 144),
    ("iw:ih:iw:ih", 192, 144),
]

CROP_SPECS = ["iw/(ih-1080)+100:100", "100:80:0:0:gt(iw,0)", "100:80:0:0:0:1", "100:80::10",
              "foo(1):2", "1:2:3:4:5:6:7", "in_w-100:in_h-100", "not:an expr", "100:80"]


def outcome(fn, *args):
    """("value", v) or ("raise", type name, message); NaN equals NaN."""
    try:
        v = fn(*args)
    except Exception as e:  # compared, not handled
        return ("raise", type(e).__name__, str(e))
    if isinstance(v, float) and math.isnan(v):
        return ("value", "nan")
    return ("value", v)


def system_exit(fn, *args):
    try:
        return ("value", fn(*args))
    except SystemExit as e:
        return ("exit", str(e.code))


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_eval_ffmpeg_expr_matches_jax(expr):
    assert outcome(trender.eval_ffmpeg_expr, expr, ENV) == \
        outcome(jrender.eval_ffmpeg_expr, expr, ENV)


@pytest.mark.parametrize("spec,w,h", CROP_RECTS)
def test_parse_crop_rect_matches_jax(spec, w, h, capsys):
    want = outcome(jrender.parse_crop_rect, spec, w, h)
    jerr = capsys.readouterr().err
    assert outcome(trender.parse_crop_rect, spec, w, h) == want
    assert capsys.readouterr().err == jerr  # the keep_aspect note


@pytest.mark.parametrize("spec", CROP_SPECS)
def test_validate_crop_spec_and_cli_validation_match_jax(spec):
    assert outcome(trender.validate_crop_spec, spec) == \
        outcome(jrender.validate_crop_spec, spec)
    assert system_exit(tcli._validated_crop, spec) == system_exit(jcli._validated_crop, spec)


def test_validated_crop_passes_the_bare_flag():
    for value in (None, True):
        assert tcli._validated_crop(value) is jcli._validated_crop(value) is None


_atoms = st.one_of(
    st.integers(-50, 400).map(str),
    st.floats(0, 1e3, allow_nan=False).map(lambda f: f"{f:.3g}"),
    st.sampled_from(["iw", "ih", "in_w", "out_h", "ow", "oh", "x", "y", "a", "zz", "1e3",
                     "2.5E-1", ".5", "1e", "e"]),
)


def _compose(children):
    binary = st.tuples(children, st.sampled_from(["+", "-", "*", "/", "^", " ^ -", "*-"]),
                       children).map("".join)
    call = st.tuples(st.sampled_from(["min", "max", "abs", "floor", "ceil", "trunc", "round",
                                      "mod", "pow", "if", "gt", "gte", "lt", "lte", "eq",
                                      "nope"]),
                     st.lists(children, min_size=1, max_size=3)).map(
        lambda t: f"{t[0]}({','.join(t[1])})")
    return st.one_of(binary, call, children.map(lambda c: f"({c})"),
                     children.map(lambda c: f"-{c}"), children.map(lambda c: f"--{c}"),
                     st.tuples(children, st.sampled_from(["(", ")", ";", ",", " "])).map("".join))


EXPR = st.recursive(_atoms, _compose, max_leaves=12)


@settings(derandomize=True, max_examples=400, deadline=None)
@given(EXPR)
def test_eval_ffmpeg_expr_matches_jax_on_generated_expressions(expr):
    env = {"iw": 192.0, "ih": 144.0, "in_w": 192.0, "out_h": 80.0, "ow": 100.0,
           "oh": 80.0, "x": 3.0, "y": math.nan, "a": 4 / 3}
    assert outcome(trender.eval_ffmpeg_expr, expr, env) == \
        outcome(jrender.eval_ffmpeg_expr, expr, env)


@settings(derandomize=True, max_examples=300, deadline=None)
@given(st.lists(EXPR, min_size=1, max_size=6), st.integers(2, 400), st.integers(2, 300),
       st.booleans())
def test_crop_specs_match_jax_on_generated_specs(fields, w, h, trailing):
    spec = ":".join(fields) + (":" if trailing else "")
    assert outcome(trender.validate_crop_spec, spec) == \
        outcome(jrender.validate_crop_spec, spec)
    assert outcome(trender.parse_crop_rect, spec, w, h) == \
        outcome(jrender.parse_crop_rect, spec, w, h)
