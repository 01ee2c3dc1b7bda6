"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, imports on a machine without triton, nvcc or a GPU, and never
quietly runs a plain version for a tensor that lies on another device than
the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "torchain_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "torchain_tpu", "triton")

_PROBE = f"""
import importlib, pkgutil, sys
banned = {BANNED!r}
def present():
    return sorted(m for m in sys.modules if m.split('.')[0] in banned)
before = present()
import torchain_tpu_torch
for info in pkgutil.walk_packages(torchain_tpu_torch.__path__, 'torchain_tpu_torch.'):
    importlib.import_module(info.name)
import chip_smoke
print(sorted(set(present()) - set(before)))
"""


def test_port_imports_nothing_of_jax_in_a_fresh_interpreter():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=str(ROOT), capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


#: the recurrent and CNN trunks, the trunk lowerings, the optimizers and the
#: entry points that take them
NEW_MODULES = ("models.lstm", "models.cnn", "models.conformer", "models.tdnn",
               "train.lowmem_adam", "train.ngsgd", "train.trainer", "convert", "cli.train",
               "cli.compute_prob", "parallel.mesh", "parallel.sharding", "ops.sharded",
               "tools.multihost_worker", "train.captured", "train.chain_tx")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_trunk_and_optimizer_modules_import_with_jax_blocked(module):
    """Each imports, and builds its model or optimizer, in an interpreter
    where importing jax, flax, optax or torchain_tpu raises."""
    probe = (
        "import sys\n"
        f"for name in {BANNED[:-1]!r}: sys.modules[name] = None\n"
        f"import torchain_tpu_torch.{module}\n"
        "from torchain_tpu_torch.models import CNNTDNN, TDNNLSTM, CnnTdnnConfig, TdnnLstmConfig\n"
        "from torchain_tpu_torch.train import NGSGD, LowmemAdam\n"
        "import torch\n"
        "m = TDNNLSTM(TdnnLstmConfig(hidden_dim=8, cell_dim=8, rec_proj_dim=2,"
        " nonrec_proj_dim=2, prefinal_dim=4), 5, device='cpu')\n"
        "c = CNNTDNN(CnnTdnnConfig(feat_dim=8, hidden_dim=8, bottleneck_dim=2, prefinal_dim=4,"
        " num_tdnnf_layers=2), device='cpu')\n"
        "NGSGD(list(m.parameters())); LowmemAdam(list(c.parameters()))\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=str(ROOT), capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
)
def test_no_import_statement_names_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in BANNED[:-1], f"{path}:{node.lineno} imports {n}"


def test_wrappers_raise_for_a_non_cpu_non_cuda_tensor():
    """A wrapper takes its plain version only for CPU tensors; for any
    other device it launches the kernel or raises (checked before any
    build is attempted)."""
    from torchain_tpu_torch.ops import den_resident as dr
    from torchain_tpu_torch.ops import num_resident as nr
    from torchain_tpu_torch.ops import num_scan as ns

    m = dict(device="meta")
    # S_pad=4, K=2, P=3: slot e emits pdf e % 3 and is entered from state e % 4
    V = np.zeros((4, 8), np.float32)
    V[np.arange(8) % 4, np.arange(8)] = 0.5
    g = dr.DeviceResidentDenGraph.from_dense(
        V, np.arange(8, dtype=np.int32) % 3, np.full(4, 0.25, np.float32), 3, 4, device="meta")
    p = torch.empty(2, 1, 3, **m)
    with pytest.raises(ValueError, match="CUDA"):
        dr.den_forward_kernel(p, g, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        dr.den_backward_kernel(p, torch.empty(2, 1, 8, **m), torch.empty(2, 1, **m),
                               torch.empty(2, 1, **m), torch.empty(1, **m), g, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        ns.vocab_gather(torch.empty(1, 2, 3, **m), torch.empty(1, 2, 2, dtype=torch.int32, **m))
    with pytest.raises(ValueError, match="CUDA"):
        ns.vocab_scatter(torch.empty(2, 1, 2, **m), torch.empty(1, 2, 2, dtype=torch.int32, **m), 3)
    # B=1, T-1=2, S=3, Kr=4, W=5
    tables = (torch.empty(1, 2, 3, 4, dtype=torch.int64, **m),
              torch.empty(1, 2, 3, 4, dtype=torch.int64, **m), torch.empty(1, 2, 3, 4, **m))
    ysm = torch.empty(1, 2, 5, **m)
    with pytest.raises(ValueError, match="CUDA"):
        nr.steady_forward(torch.empty(1, 3, **m), *tables, ysm)
    with pytest.raises(ValueError, match="CUDA"):
        nr.steady_backward(*tables, ysm, torch.empty(2, 1, 3, **m), torch.empty(1, 3, **m),
                           torch.empty(1, **m))
    assert dr.den_forward_kernel.launches == 0 and dr.den_backward_kernel.launches == 0
    assert ns.vocab_gather.launches == 0
    assert nr.steady_forward.launches == 0 and nr.steady_backward.launches == 0


def test_attention_and_ffn_wrappers_raise_for_a_non_cpu_non_cuda_tensor():
    """K7f, K7b, K10f and K10b likewise: no plain version for a tensor that
    is not on the CPU, and the refusal comes before any build."""
    from torchain_tpu_torch import kernels
    from torchain_tpu_torch.ops import attention as at
    from torchain_tpu_torch.ops import fused_ffn as ff

    m = dict(device="meta")
    qkv, bias = torch.empty(2, 5, 3 * 8, **m), torch.empty(2, 5, 5, **m)
    with pytest.raises(ValueError, match="CUDA"):
        at.attention_forward(qkv, bias, 2, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        at.attention_backward(qkv, bias, torch.empty(2, 5, 8, **m), 2, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        at.fused_relpos_attention(qkv, bias, 2, 0.5)
    xn, w1, b1 = torch.empty(6, 8, **m), torch.empty(8, 16, **m), torch.empty(16, **m)
    w2, b2 = torch.empty(16, 8, **m), torch.empty(8, **m)
    with pytest.raises(ValueError, match="CUDA"):
        ff.ffn_forward(xn, xn, w1, b1, w2, b2, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        ff.ffn_backward(xn, xn, w1, b1, w2, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        ff.ffn_apply(xn, xn, w1, b1, w2, b2)
    assert at.attention_forward.launches == 0 and at.attention_backward.launches == 0
    assert ff.ffn_forward.launches == 0 and ff.ffn_backward.launches == 0
    assert "attention" not in kernels._libs and "fused_ffn" not in kernels._libs


def test_e2e_dense_and_probe_wrappers_raise_for_a_non_cpu_non_cuda_tensor():
    """K8f, K8b, K9f, K9b and T1 likewise, through the wrappers and through
    the entry points that reach them (ops/num_e2e.py, ops/den_pallas.py and
    the chain loss's dispatch): no plain version for a tensor that is not
    on the CPU, and the refusal comes before any build."""
    from torchain_tpu_torch import kernels
    from torchain_tpu_torch.graphs import DenGraph, make_dense_den_graph
    from torchain_tpu_torch.ops import DeviceDenseDenGraph, chain_loss
    from torchain_tpu_torch.ops import den_pallas as dp
    from torchain_tpu_torch.ops import num_resident as nr
    from torchain_tpu_torch.tools import probe_smem as ps

    m = dict(device="meta")
    # B=2, T=3, S=4, K=2
    ylocal, src = torch.empty(2, 3, 4, 2, **m), torch.empty(2, 4, 2, dtype=torch.int64, **m)
    logw = torch.empty(2, 4, 2, **m)
    with pytest.raises(ValueError, match="CUDA"):
        nr.e2e_forward_resident(ylocal, src, logw)
    with pytest.raises(ValueError, match="CUDA"):
        nr.e2e_backward_resident(ylocal, torch.empty(3, 2, 4, **m), src, logw,
                                 torch.empty(2, 4, **m), torch.empty(2, **m))
    host = DenGraph(
        num_states=2, num_pdfs=2,
        in_offsets=np.array([0, 1, 2], np.int32), in_src=np.array([1, 0], np.int32),
        in_pdf=np.array([0, 1], np.int32), in_logw=np.zeros(2, np.float32),
        out_offsets=np.array([0, 1, 2], np.int32), out_dst=np.array([1, 0], np.int32),
        out_pdf=np.array([1, 0], np.int32), out_logw=np.zeros(2, np.float32),
        initial_probs=np.array([0.5, 0.5], np.float32),
    )
    g = DeviceDenseDenGraph.from_host(make_dense_den_graph(host, pad_to=4), device="meta",
                                      fused=True)
    assert g.V.device.type == "meta" and g.fused and g.real_exp == 2 and g.num_exp == 4
    pe = torch.empty(3, 2, g.num_exp, **m)
    with pytest.raises(ValueError, match="CUDA"):
        dp.dense_forward_kernel(pe, g, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        dp.dense_backward_kernel(pe, g, torch.empty(3, 2, g.num_orig, **m),
                                 torch.empty(3, 2, **m), torch.empty(3, 2, **m), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        ps.try_size(torch.empty(128, **m), 64)
    assert nr.e2e_forward_resident.launches == 0 and nr.e2e_backward_resident.launches == 0
    assert dp.dense_forward_kernel.launches == 0 and dp.dense_backward_kernel.launches == 0
    assert ps.try_size.launches == 0
    assert not {"num_e2e", "den_dense", "probe_smem"} & set(kernels._libs)
    assert chain_loss is not None


def test_probe_smem_runs_its_plain_version_on_cpu_tensors(capsys):
    """T1's wrapper on a CPU tensor returns 5x without a launch; the loop
    over sizes reports PASS per size; the command refuses to run without a card."""
    from torchain_tpu_torch.tools import probe_smem as ps

    x = torch.arange(128, dtype=torch.float32)
    assert torch.equal(ps.try_size(x, 64), 5.0 * x)
    with pytest.raises(ValueError, match="1 KiB"):
        ps.try_size(x, 0)
    lines = []
    assert ps.largest([64, 16], device="cpu", log=lines.append) == 64
    assert lines == ["shared memory 16 KiB: PASS", "shared memory 64 KiB: PASS"]
    assert ps.try_size.launches == 0
    if not torch.cuda.is_available():
        assert ps.main([]) == 2
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["attention", "fused_ffn", "num_e2e", "den_dense", "probe_smem"])
def test_every_kernel_source_is_registered(name):
    """kernels.build compiles what SIGNATURES names: each source under
    csrc/ has an entry, and each entry point named there is in the source."""
    from torchain_tpu_torch import kernels

    assert {p.stem for p in kernels.CSRC.glob("*.cu")} == set(kernels.SIGNATURES)
    text = (kernels.CSRC / f"{name}.cu").read_text()
    for fn in kernels.SIGNATURES[name]:
        assert f" {fn}(" in text, fn
    assert "atomicAdd" not in text


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback when the kernels cannot be built."""
    from torchain_tpu_torch import kernels

    monkeypatch.setattr(kernels, "BUILD", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda _name: None)
    monkeypatch.setattr(kernels, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.library("num_vocab")
    assert "num_vocab" not in kernels._libs


def test_auto_den_graph_keeps_the_requested_device():
    from torchain_tpu_torch.graphs import DenGraph
    from torchain_tpu_torch.ops import auto_den_graph

    g = DenGraph(
        num_states=2, num_pdfs=2,
        in_offsets=np.array([0, 1, 2], np.int32), in_src=np.array([1, 0], np.int32),
        in_pdf=np.array([0, 1], np.int32), in_logw=np.zeros(2, np.float32),
        out_offsets=np.array([0, 1, 2], np.int32), out_dst=np.array([1, 0], np.int32),
        out_pdf=np.array([1, 0], np.int32), out_logw=np.zeros(2, np.float32),
        initial_probs=np.array([0.5, 0.5], np.float32),
    )
    den = auto_den_graph(g, pad_to=8, device="meta")
    assert den.V.device.type == "meta" and den.num_states == 8


#: the Kaldi interchange modules: port module -> (JAX module, names the
#: port leaves out).  Nothing is left out: select_device checks a torch
#: device, and kaldi_compat's two feature functions run data/features.py.
KALDI_MODULES = {
    "torchain_tpu_torch.utils.kaldi_io": ("torchain_tpu.utils.kaldi_io", set()),
    "torchain_tpu_torch.fstkit.algorithms": ("torchain_tpu.fstkit.algorithms", set()),
    "torchain_tpu_torch.fstkit.openfst_io": ("torchain_tpu.fstkit.openfst_io", set()),
    "torchain_tpu_torch.fstkit": ("torchain_tpu.fstkit", set()),
    "torchain_tpu_torch.io": ("torchain_tpu.io", set()),
    "torchain_tpu_torch.data.cegs": ("torchain_tpu.data.cegs", set()),
    "torchain_tpu_torch.cli.graphs": ("torchain_tpu.cli.graphs", set()),
    "torchain_tpu_torch.cli.egs": ("torchain_tpu.cli.egs", set()),
    "torchain_tpu_torch.graphs.transition_model": ("torchain_tpu.graphs.transition_model", set()),
    "torchain_tpu_torch.graphs.tied_tree": ("torchain_tpu.graphs.tied_tree", set()),
    "torchain_tpu_torch.graphs.lattice_supervision": (
        "torchain_tpu.graphs.lattice_supervision", set()),
    "torchain_tpu_torch.graphs.nnet3": ("torchain_tpu.graphs.nnet3", set()),
    "torchain_tpu_torch.graphs.den_graph": ("torchain_tpu.graphs.den_graph", set()),
    "torchain_tpu_torch.graphs": ("torchain_tpu.graphs", set()),
    "torchain_tpu_torch.data.kaldi_compat": ("torchain_tpu.data.kaldi_compat", set()),
}

#: the modules of the Kaldi model files, each imported alone in a fresh
#: interpreter by `test_the_kaldi_model_modules_import_no_jax_and_no_features`
KALDI_MODEL_MODULES = ("torchain_tpu_torch.graphs.transition_model",
                       "torchain_tpu_torch.graphs.tied_tree",
                       "torchain_tpu_torch.graphs.lattice_supervision",
                       "torchain_tpu_torch.graphs.nnet3",
                       "torchain_tpu_torch.data.kaldi_compat",
                       "torchain_tpu_torch.cli.graphs")


@pytest.mark.parametrize("name", KALDI_MODEL_MODULES)
def test_the_kaldi_model_modules_import_no_jax_and_no_features(name):
    """Each module of the Kaldi model files, imported alone, brings in no
    module of JAX or of the JAX package, and no features module (the
    raw-audio half of kaldi_compat imports data/features.py where it is
    called)."""
    probe = (f"import sys; import {name}; print(sorted(m for m in sys.modules"
             f" if m.split('.')[0] in {BANNED!r} or 'features' in m))")
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=str(ROOT), capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["torchain_tpu_torch.data.loader",
                                  "torchain_tpu_torch.data.materialize",
                                  "torchain_tpu_torch.data.ivector",
                                  "torchain_tpu_torch.data.augment"])
def test_the_host_data_modules_import_no_torch(name):
    """The loader with its egs cache, MaterializedBatches (torch only where
    it places batches), the i-vectors and the speed perturbation are host
    code: imported alone (the data package with them), they bring in
    neither torch nor the feature front, as the Kaldi modules above do
    not."""
    probe = (f"import sys; import {name}; print(sorted(m for m in sys.modules"
             f" if m.split('.')[0] in {BANNED + ('torch',)!r} or 'features' in m))")
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=str(ROOT), capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


#: the decode ladder: port module -> (JAX module, names the port leaves
#: out).  native.py builds with the compiler itself (build, _compiler,
#: _declare) where the JAX module ran make (_build).
DECODE_MODULES = {
    "torchain_tpu_torch.eval.wer": ("torchain_tpu.eval.wer", set()),
    "torchain_tpu_torch.eval.decoder": ("torchain_tpu.eval.decoder", set()),
    "torchain_tpu_torch.eval.lattice": ("torchain_tpu.eval.lattice", set()),
    "torchain_tpu_torch.eval.native": ("torchain_tpu.eval.native", {"_build"}),
    "torchain_tpu_torch.eval.align": ("torchain_tpu.eval.align", set()),
    "torchain_tpu_torch.eval": ("torchain_tpu.eval", set()),
    "torchain_tpu_torch.graphs.hclg": ("torchain_tpu.graphs.hclg", set()),
    "torchain_tpu_torch.data.words": ("torchain_tpu.data.words", set()),
    "torchain_tpu_torch.cli.decode": ("torchain_tpu.cli.decode", set()),
}
#: the raw-audio front and the egs cache: port module -> (JAX module, names
#: the port leaves out)
RAW_AUDIO_MODULES = {
    "torchain_tpu_torch.data.features": ("torchain_tpu.data.features", set()),
    "torchain_tpu_torch.data.augment": ("torchain_tpu.data.augment", set()),
    "torchain_tpu_torch.data.synth_wav": ("torchain_tpu.data.synth_wav", set()),
    "torchain_tpu_torch.data.ivector": ("torchain_tpu.data.ivector", set()),
    "torchain_tpu_torch.data.materialize": ("torchain_tpu.data.materialize", set()),
    "torchain_tpu_torch.data.loader": ("torchain_tpu.data.loader", set()),
}
REFERENCE_MODULES = {**KALDI_MODULES, **DECODE_MODULES, **RAW_AUDIO_MODULES}


@pytest.mark.parametrize("name", sorted(REFERENCE_MODULES))
def test_kaldi_modules_keep_the_reference_names(name):
    """Each module keeps every function and class of its JAX counterpart,
    under the same name, and defines them itself (no re-export from the
    JAX package)."""
    import importlib
    import inspect

    pytest.importorskip("jax")
    ref_name, left_out = REFERENCE_MODULES[name]
    port, ref = importlib.import_module(name), importlib.import_module(ref_name)

    def defined(mod):
        return {k for k, v in vars(mod).items()
                if (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__.split(".")[0] == mod.__name__.split(".")[0]}

    assert defined(ref) - left_out <= defined(port)
    assert all(getattr(port, k).__module__.startswith("torchain_tpu_torch") for k in defined(port))
    if hasattr(ref, "__all__"):
        assert set(ref.__all__) - left_out <= set(port.__all__)


def test_the_data_package_exports_the_jax_packages_names():
    """Every name of the JAX package's data/__init__.py is exported by the
    port's, and resolves there to a port object (the feature front's names
    are loaded where first used)."""
    import importlib
    import inspect

    pytest.importorskip("jax")
    port = importlib.import_module("torchain_tpu_torch.data")
    ref = importlib.import_module("torchain_tpu.data")
    assert set(ref.__all__) <= set(port.__all__)
    for name in port.__all__:
        obj = getattr(port, name)
        if inspect.isfunction(obj) or inspect.isclass(obj):
            assert obj.__module__.startswith("torchain_tpu_torch."), name


RECIPE = ("cli/train.py", "cli/compute_prob.py", "cli/export_posteriors.py", "train/trainer.py",
          "train/step.py", "train/state.py", "data/prefetch.py", "models/semi_orthogonal.py")


def test_the_recipe_entry_points_are_walked_and_default_to_the_card():
    """The fresh-interpreter walk and the import-statement check above reach
    the recipe's entry points and the trainer; each entry point and the
    Trainer run on "cuda" unless the caller asks for the CPU."""
    from torchain_tpu_torch.cli import compute_prob, export_posteriors, train
    from torchain_tpu_torch.train import TrainerConfig

    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert set(RECIPE) <= walked
    assert train.build_argparser().parse_args(["--synthetic"]).device == "cuda"
    assert compute_prob.build_argparser().parse_args(
        ["--cegs", "x", "--den-fst", "y"]).device == "cuda"
    assert export_posteriors.build_argparser().parse_args(["--out", "x"]).device == "cuda"
    assert TrainerConfig().device == "cuda"


DECODE = ("eval/__init__.py", "eval/wer.py", "eval/decoder.py", "eval/lattice.py",
          "eval/native.py", "eval/align.py", "graphs/hclg.py", "data/words.py",
          "data/kaldi_compat.py", "cli/decode.py")


def test_the_decode_modules_are_walked_and_the_symbol_tables_are_kept():
    import importlib

    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert set(DECODE) <= walked
    kc = importlib.import_module("torchain_tpu_torch.data.kaldi_compat")
    assert {"read_phone_table", "read_symbol_table", "write_symbol_table"} <= set(vars(kc))
    # the raw-audio functions are named, and defined here
    assert "compute_feats_from_wav_scp" in kc.__doc__ and "load_wav_dir" in kc.__doc__
    assert {"compute_feats_from_wav_scp", "load_wav_dir"} <= set(vars(kc))
    from torchain_tpu_torch.cli import decode

    flags = {a for act in decode.build_argparser()._actions for a in act.option_strings}
    assert "--device" not in flags
    assert {"--hclg", "--mdl", "--tree"} <= flags
    assert {"--nbest", "--lattice-out", "--ctm-out", "--prune-beam", "--lm-rescore",
            "--lm-rescore-old", "--mbr", "--confidence-out", "--oracle", "--lmwt-min",
            "--lmwt-max", "--word-symbols", "--backend", "--max-active",
            "--phone-insertion-bonus"} <= flags


def test_native_library_is_the_ports_own():
    """The port builds csrc/decoder.cc of its own package into its own
    git-ignored build/, and nothing in eval/native.py reaches the repo
    root's csrc/ (the JAX package's Makefile and library)."""
    from torchain_tpu_torch.eval import native

    assert native.SOURCE == PORT / "csrc" / "decoder.cc"
    assert native.LIBRARY.parent == PORT / "build"
    assert "torchain_tpu_torch/build/" in (ROOT / ".gitignore").read_text()
    text = (PORT / "eval" / "native.py").read_text()
    for reach in ("parent.parent.parent", "parents[2]", '"make"', "Makefile",
                  "libtorchain_tpu_native"):
        assert reach not in text, reach
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert str(ROOT / "csrc") not in node.value


def test_native_build_writes_only_into_its_build_dir(monkeypatch, tmp_path):
    from torchain_tpu_torch.eval import native

    root_csrc = sorted((p.name, p.stat().st_mtime) for p in (ROOT / "csrc").iterdir())
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "libdecoder.so")
    assert native.build(force=True)
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["libdecoder.so"]
    assert sorted((p.name, p.stat().st_mtime) for p in (ROOT / "csrc").iterdir()) == root_csrc
    # a library newer than its source is not rebuilt
    mtime = native.LIBRARY.stat().st_mtime_ns
    assert native.build()
    assert native.LIBRARY.stat().st_mtime_ns == mtime


def test_native_build_failure_raises_and_no_compiler_says_so(monkeypatch, tmp_path, capsys):
    """A compiler that fails raises with its output (never a quiet NumPy
    decode); only where no compiler is found does backend="auto" run the
    NumPy reference, and it says so once."""
    from torchain_tpu_torch.eval import decoder, native

    bad = tmp_path / "decoder.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "libdecoder.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    with pytest.raises(RuntimeError, match="failed to build decoder.cc"):
        native.get_lib()
    assert not (tmp_path / "build" / "libdecoder.so").exists()
    assert list((tmp_path / "build").iterdir()) == []  # the temporary is gone

    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert native.get_lib() is None and native.get_lib() is None
    assert capsys.readouterr().err.count("no C++ compiler") == 1
    from torchain_tpu_torch.fstkit import Fst

    f = Fst()
    f.add_states(2)
    f.add_arc(0, 1, -0.1, 1)
    f.add_arc(1, 1, -0.2, 1)
    f.set_final(1)
    g = decoder.pack_decoding_graph(f, [3, 0], 1)
    y = np.zeros((3, 1), np.float32)
    assert decoder.viterbi_decode(g, y, backend="auto")[0] == [3]
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        decoder.viterbi_decode(g, y, backend="native")
