"""The port twin of tests/test_option_surface.py: every name in the
reference's long_options table (that file's frozen REF_OPTIONS) has the
same outcome on the port's align parser as on the JAX one: parsed, exited
with 0 (--help, --version, --usage, --arg-desc), or rejected with "is not
supported: <reason>"."""
import contextlib
import io

import pytest

from bowtie2_server_tpu.__main__ import make_parser as jax_parser
from bowtie2_server_tpu_torch.__main__ import make_parser as port_parser
from test_option_surface import REF_OPTIONS


def outcome(make_parser, name, kind):
    args = ["align", "-x", "X", "-U", "r.fq", "--" + name]
    if kind == "required_argument":
        args.append("1")
    err, out = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(out):
            make_parser().parse_args(args)
    except SystemExit as e:
        if e.code in (0, None):
            return "exit 0"
        msg = err.getvalue()
        if f"--{name} is not supported:" in msg:
            return "reject"
        return "error: " + (msg.strip().splitlines() or ["?"])[-1]
    return "parsed"


@pytest.mark.parametrize("name,kind", REF_OPTIONS,
                         ids=[n for n, _ in REF_OPTIONS])
def test_option_outcome_as_jax_parser(name, kind):
    got = outcome(port_parser, name, kind)
    assert got == outcome(jax_parser, name, kind)
    assert not got.startswith("error")


def test_every_jax_option_string_is_taken():
    """The port's align takes every option string of the JAX align (and
    --device beside --cpu)."""
    def strings(p):
        sub = next(a for a in p._actions
                   if isinstance(a, type(p._subparsers._group_actions[0])))
        return {o for a in sub.choices["align"]._actions
                for o in a.option_strings}
    jax, port = strings(jax_parser()), strings(port_parser())
    assert port - jax == {"--device"}
    assert jax <= port
