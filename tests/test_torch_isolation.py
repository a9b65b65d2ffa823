"""The PyTorch port stands alone: no module of atsc_tpu_torch (nor the
on-card scripts) imports JAX or the JAX package, and every host-side table
the port copied is equal, value and dtype, to the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "atsc_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "atsc_tpu")


def _port_tools() -> list[str]:
    """Every tools/torch_*.py: the port's own scripts."""
    return sorted(os.path.relpath(p, REPO)
                  for p in glob.glob(os.path.join(REPO, "tools", "torch_*.py")))


def _port_sources() -> list[str]:
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    out.append(os.path.join(REPO, "chip_smoke.py"))
    return sorted(os.path.relpath(p, REPO) for p in out) + _port_tools()


@pytest.mark.parametrize("path", _port_sources())
def test_no_jax_import_in_source(path):
    """AST scan: no `import jax...`, `from jax... import`, or import of
    the atsc_tpu package, anywhere in the file (function bodies too)."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


_REFUSE_JAX = f"""
import sys
FORBIDDEN = {_FORBIDDEN!r}
for k in list(sys.modules):
    if k.split('.')[0] in FORBIDDEN:
        del sys.modules[k]
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            raise ImportError('refused: ' + name)
        return None
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {REPO!r})
"""


def _run_refusing_jax(code: str) -> str:
    """Run code in a fresh interpreter that refuses jax and atsc_tpu
    outright (a sys.meta_path finder); its stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFUSE_JAX + code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_every_port_module_imports_with_jax_refused():
    """Every module of the port imports where jax and atsc_tpu cannot."""
    out = _run_refusing_jax("""
import pkgutil
import atsc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(atsc_tpu_torch.__path__, 'atsc_tpu_torch.')]
for n in names:
    __import__(n)
assert not [k for k in sys.modules if k.split('.')[0] in FORBIDDEN]
print(len(names), 'modules')
""")
    assert int(out.split()[0]) >= 52, out


@pytest.mark.parametrize("path", _port_tools())
def test_port_tool_imports_with_jax_refused(path):
    """Each tools/torch_*.py imports (without running its main) where jax
    and atsc_tpu cannot."""
    out = _run_refusing_jax(f"""
import importlib.util
spec = importlib.util.spec_from_file_location('tool', {os.path.join(REPO, path)!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not [k for k in sys.modules if k.split('.')[0] in FORBIDDEN]
print('imported')
""")
    assert out.strip() == "imported", out


def _params_cases():
    from atsc_tpu import params as jp

    return [f"params.{k}" for k in sorted(vars(jp)) if k.isupper()]


_TABLE_CASES = [
    "lfsr.pn511", "lfsr.pn63", "lfsr.lfsr_bits",
    "galois.gf_tables", "galois.gf_mul", "galois.rs_generator_poly",
    "galois.rs_encode_segment_np", "galois.rs_bit_matrix",
    "randomizer.randomizer_table", "randomizer.randomize_field_np",
    "interleave._scatter_table", "interleave.gather_tables",
    "interleave.interleave_field_np",
    "trellis_tables.commutator_gather", "trellis_tables.padded_field_gather",
    "trellis_tables.encoder_stream_to_round_major",
    "sync.field_sync_symbol_values", "sync.field_sync_symbols",
    "sync.segment_sync_symbols", "sync.sync_templates",
    "sync.sync_symbol_templates", "sync.RESERVED_START",
    "rrc.rrc_taps", "spec.SHIPPED_RRC_TAPS",
    "oscillator.phase_increment", "oscillator.oscillator_table",
    "oscillator.field_scale", "oscillator.phasor_for_field",
    "oscillator._phasor_replay_np",
    # the soft and NTSC trellis tiers (the port's ops/cuda/viterbi_acs.py
    # holds what the JAX package keeps in ops/pallas/viterbi_acs.py)
    "ops.viterbi._constellation", "ops.viterbi._BIG", "ops.viterbi._NSYM",
    "ops.viterbi._NB", "ops.viterbi._PRED0", "ops.viterbi._PRED1", "ops.viterbi._B_OF",
    "ops.ntsc._pr_reset_tables", "ops.ntsc._pr_tables", "ops.ntsc._SYNC_LEVELS",
    "ops.ntsc._COMB_DELAY", "ops.ntsc._BIG", "ops.ntsc._PRED0", "ops.ntsc._PRED1",
    "ops.cuda.viterbi_acs._pr_rc_table",
    "ops.cuda.viterbi_acs.GROUP",
    "ops.quantize.SOFT_LEVEL_INV", "ops.quantize.SOFT_LEVEL_SCALE",
]

# the port module -> the JAX package module holding the same name, where
# they differ (the JAX package names the group _GROUP)
_JAX_MODULE = {"ops.cuda.viterbi_acs": "ops.pallas.viterbi_acs"}
_JAX_NAME = {"GROUP": "_GROUP"}


def _call(mod, name: str, which: str):
    """The value of table `name` from the JAX package (which='jax') or the
    port, with the same seeded arguments for the functions that take any."""
    import importlib

    root = "atsc_tpu" if which == "jax" else "atsc_tpu_torch"
    if mod.startswith("ops."):
        if which == "jax":
            mod, name = _JAX_MODULE.get(mod, mod), _JAX_NAME.get(name, name)
        obj = getattr(importlib.import_module(f"{root}.{mod}"), name)
        return obj() if callable(obj) else obj
    if mod == "params":
        return getattr(importlib.import_module(f"{root}.params"), name)
    if mod == "spec":
        return getattr(importlib.import_module(f"{root}.spec.shipped_rrc"), name)
    obj = getattr(importlib.import_module(f"{root}.tables.{mod}"), name)
    if not callable(obj):
        return obj
    rng = np.random.default_rng(11)
    args = {
        "lfsr_bits": (0b1011, 3, 0b1101, 100),
        "gf_mul": (rng.integers(0, 256, 300).astype(np.uint8),
                   rng.integers(0, 256, 300).astype(np.uint8)),
        "rs_encode_segment_np": (rng.integers(0, 256, 187).astype(np.uint8),),
        "randomize_field_np": (rng.integers(0, 256, 58656).astype(np.uint8),),
        "interleave_field_np": (rng.integers(0, 256, 64584).astype(np.uint8),
                                rng.integers(0, 256, 64584).astype(np.uint8)),
    }.get(name, ())
    if name in ("phasor_for_field", "_phasor_replay_np"):
        # 300 takes the native replay once it is verified, 5 the numpy loop
        return [obj(k) for k in (0, 1, 5, 300)]
    return obj(*args)


def _assert_same(got, want, what):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        assert np.array_equal(got, want), what
        return
    assert type(got) is type(want) and got == want, what


@pytest.mark.parametrize("case", _params_cases() + _TABLE_CASES)
def test_copied_contract_equals_jax_package(case):
    mod, name = case.rsplit(".", 1)
    _assert_same(_call(mod, name, "port"), _call(mod, name, "jax"), case)


def test_viterbi_levels_equal_jax_kernel_levels():
    """The ACS's 8 levels (ops.viterbi._constellation, float32) equal the
    JAX kernel's, which it keeps as a tuple of Python floats (exact
    conversions of the same float32s)."""
    from atsc_tpu.ops.pallas.viterbi_acs import _levels8 as jax_levels
    from atsc_tpu_torch.ops.viterbi import _constellation

    got = _constellation()
    assert got.dtype == np.float32
    assert got.tolist() == list(jax_levels())


def test_port_params_have_no_extra_names():
    from atsc_tpu import params as jp
    from atsc_tpu_torch import params as tp

    assert ({k for k in vars(tp) if k.isupper()}
            == {k for k in vars(jp) if k.isupper()})
