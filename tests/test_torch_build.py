"""dmtpu_torch.ops._build on the CPU, with a stand-in for ``nvcc``.

The real compiler exists only on a CUDA machine; here a small script takes
its place.  It writes the file named by ``-o``, prints a ptxas-like line for
each compile, and fails on a source that holds ``#error``.  A compile also
waits (up to 20 s) until every source of the directory has started
compiling, so a build that ran its compiles one after the other fails.
"""
import os
import stat
import sys
import textwrap

import pytest

from dmtpu_torch.dev import k2_probe
from dmtpu_torch.ops import _build

FAKE_NVCC = textwrap.dedent("""\
    import pathlib, sys, time
    args = sys.argv[1:]
    out = pathlib.Path(args[args.index("-o") + 1])
    if "-c" in args:
        src = pathlib.Path(args[-1])
        (out.parent / (src.stem + ".started")).touch()
        deadline = time.time() + 20
        while len(list(out.parent.glob("*.started"))) < len(list(src.parent.glob("*.cu"))):
            if time.time() > deadline:
                sys.exit("compiles ran one after the other")
            time.sleep(0.05)
        if "#error" in src.read_text():
            sys.exit(src.name + ": error")
        print("ptxas info    : Used 32 registers in " + src.name)
    out.write_text("built from " + " ".join(args))
    """)


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    (csrc / "common.cuh").write_text("// shared header\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc


def test_build_compiles_every_source_at_once_then_links(fake_tree):
    lib = _build.build()
    out_dir = lib.parent
    assert lib.name == "libdmtpu_kernels.so" and lib.read_text().startswith("built from -shared")
    log = (out_dir / "build.log").read_text()
    for name in ("a.cu", "b.cu", "c.cu"):
        assert f"Used 32 registers in {name}" in log
    assert log.count(" -c ") == 3 and " -shared " in log
    # the objects and the private library are gone; only the published one stays
    assert sorted(p.name for p in out_dir.iterdir() if not p.name.endswith(".started")) == \
        ["build.log", "libdmtpu_kernels.so"]
    # a second call finds the library; an edited header gives a new digest
    assert _build.build() == lib
    (fake_tree / "common.cuh").write_text("// edited\n")
    assert _build.build().parent != out_dir


def test_build_failure_raises_and_publishes_nothing(fake_tree):
    (fake_tree / "b.cu").write_text("#error broken kernel\n")
    with pytest.raises(RuntimeError, match="nvcc failed.*b.cu"):
        _build.build()
    (out_dir,) = (_build.BUILD_ROOT).iterdir()
    left = sorted(p.name for p in out_dir.iterdir() if not p.name.endswith(".started"))
    assert left == ["build.log"]
    assert "b.cu: error" in (out_dir / "build.log").read_text()
    assert not os.path.exists(out_dir / "libdmtpu_kernels.so")


_C_TYPES = {"const void*": _build._P, "void*": _build._P, "int": _build._I,
            "long long": _build._L, "float": _build._F}


def _entry_points():
    """(name, ctypes argument list) of every ``extern "C" int`` function of csrc/."""
    import re
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)\s*{', src.read_text()):
            types = [" ".join(p.split()[:-1]).replace(" *", "*") for p in params.split(",")]
            found[name] = [_C_TYPES[ty] for ty in types]
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signature_matches_the_c_source(name):
    """A pointer passed as a 32-bit int is cut: every entry point's argtypes
    are held against its declaration in the CUDA source."""
    assert _build._SIGNATURES[name] == _entry_points()[name]


def test_every_entry_point_has_a_signature_and_every_source_is_built():
    assert sorted(_entry_points()) == sorted(_build._SIGNATURES)
    names = {p.name for p in _build._sources()}
    assert {"flash_attn_fwd.cu", "flash_attn_fwd_mma.cu", "flash_attn_bwd.cu",
            "flash_attn_bwd_mma.cu", "group_norm_silu.cu"} <= names
    # the headers are no translation units, but an edit to one rebuilds the library
    assert "hopper.cuh" not in names and (_build.CSRC / "hopper.cuh").exists()
    assert "compute_90a" in " ".join(_build.NVCC_FLAGS)  # wgmma and setmaxnreg need the `a`


def test_both_attention_backward_kernels_have_one_interface():
    """The dispatch passes the same arguments to either K2 kernel."""
    assert _build._SIGNATURES["dmtpu_flash_attn_bwd"] == \
        _build._SIGNATURES["dmtpu_flash_attn_bwd_mma"]
    assert _build._SIGNATURES["dmtpu_flash_attn_fwd"] == \
        _build._SIGNATURES["dmtpu_flash_attn_fwd_mma"]


@pytest.mark.parametrize("source,variant", [
    (source, name) for source, _, named in k2_probe.VARIANTS for name in named])
def test_probe_variants_still_patch_the_kernel_sources(source, variant):
    """The K2 probe times patched copies of the two backward kernels; every
    pattern must still match the source it patches, and change it."""
    (entry, named), = [(e, n) for s, e, n in k2_probe.VARIANTS if s == source]
    text = (_build.CSRC / source).read_text()
    assert entry in _build._SIGNATURES and f"int {entry}(" in text
    out = k2_probe.patched(text, named[variant])
    assert (out == text) == (variant == "as_it_is")
    with pytest.raises(ValueError, match="matches nothing"):
        k2_probe.patched(text, [("no such line in the kernel", "")])
