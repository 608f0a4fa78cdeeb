"""The port's tools and entry points against their JAX originals (CPU):
tools/import_torch_checkpoint_torch.py (the converters bit for bit
against the JAX tool followed by convert.py, the port's G with imported
weights against the reference torch modules, the CLI's checkpoints read
by generate and by a warm start), tools/seg_audio_torch.py and
tools/split_dataset_torch.py against the JAX tools on one seeded corpus,
utils/profiling.py against the cases of tests/test_profiling_and_aot.py,
and tools/aot_engine_torch.py --tiny --device cpu --out, its engine
loaded in a process that imports no JAX. No JAX compile."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import seg_audio  # noqa: E402
import seg_audio_torch  # noqa: E402
from test_torch_import import (TorchGlobalG, TorchLocalE,  # noqa: E402
                               TorchMultiD)
from tools import import_torch_checkpoint as jtool  # noqa: E402
from tools import import_torch_checkpoint_torch as tool  # noqa: E402
from tools.aot_engine_torch import main as aot_main  # noqa: E402

from pix2pixhdaudiosr_tpu.data import write_wav as jwrite_wav  # noqa: E402

from pix2pixhdaudiosr_torch import generate  # noqa: E402
from pix2pixhdaudiosr_torch.convert import (  # noqa: E402
    jax_to_torch_discriminator, jax_to_torch_generator)
from pix2pixhdaudiosr_torch.data.wavio import write_wav  # noqa: E402
from pix2pixhdaudiosr_torch.models.discriminator import \
    build_discriminator  # noqa: E402
from pix2pixhdaudiosr_torch.models.generator import build_generator  # noqa: E402
from pix2pixhdaudiosr_torch.utils.profiling import StepTimer, trace  # noqa: E402

TOY = ["--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
       "--n_blocks_global", "1", "--n_local_enhancers", "1",
       "--n_blocks_local", "1", "--input_nc", "2", "--output_nc", "2",
       "--label_nc", "0", "--no_instance", "--explicit_encoding",
       "--mask_mode", "mode2", "--compute_dtype", "float32",
       "--n_fft", "64", "--hop_length", "32", "--win_length", "64",
       "--segment_length", "480", "--ndf", "4", "--n_layers_D", "2"]
# the TorchLocalE of TOY's generator flags
TOY_G = dict(input_nc=2, output_nc=2, ngf=4, n_down_g=2, n_blocks_g=1,
             nle=1, n_blocks_l=1)


def _reference_g(net_g: str, seed: int):
    torch.manual_seed(seed)
    if net_g == "global":
        return TorchGlobalG(2, 2, ngf=8, n_down=2, n_blocks=2), dict(
            net_g="global", n_downsample_global=2, n_blocks_global=2)
    return TorchLocalE(2, 2, ngf=4, n_down_g=2, n_blocks_g=1, nle=1,
                       n_blocks_l=2), dict(
        net_g="local", n_downsample_global=2, n_blocks_global=1,
        n_local_enhancers=1, n_blocks_local=2)


def _port_g(kw, deconv_mode="torch"):
    return build_generator(kw["net_g"], 2, 2, 8 if kw["net_g"] == "global"
                           else 4, kw["n_downsample_global"],
                           kw["n_blocks_global"],
                           kw.get("n_local_enhancers", 1),
                           kw.get("n_blocks_local", 3),
                           deconv_mode=deconv_mode, device="cpu")


def _bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("net_g", ["global", "local"])
def test_generator_conversion_equals_the_jax_chain(net_g):
    """convert_generator_state_dict gives, bit for bit, what the JAX tool's
    converter followed by convert.jax_to_torch_generator gives, and the
    tensors of the reference's state_dict unchanged."""
    tm, kw = _reference_g(net_g, seed=0)
    sd = tm.state_dict()
    got = tool.convert_generator_state_dict(sd, **kw)
    want = jax_to_torch_generator(jtool.convert_generator_state_dict(
        {k: v.numpy() for k, v in sd.items()}, **kw))
    _bit_equal(got, want)
    assert sorted(t.data_ptr() for t in got.values()) == sorted(
        t.data_ptr() for t in sd.values())


@pytest.mark.parametrize("net_g", ["global", "local"])
def test_imported_generator_matches_the_reference(net_g, rng_np):
    """The port's G (torch deconv mode) with the converted weights within
    the JAX test's atol 2e-4 / rtol 1e-3 of the reference torch modules."""
    tm, kw = _reference_g(net_g, seed=1)
    net = _port_g(kw)
    net.load_state_dict(tool.convert_generator_state_dict(tm.state_dict(),
                                                          **kw))
    x = torch.from_numpy((rng_np.standard_normal((2, 2, 32, 32)) * 0.5)
                         .astype(np.float32))
    tm.eval()
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), tm(x).numpy(),
                                   atol=2e-4, rtol=1e-3)


class _FlatD(torch.nn.Module):
    """The reference's MultiscaleDiscriminator without getIntermFeat: each
    scale one `layer<i>` Sequential, convs at stream index 0 and 3j - 1."""

    def __init__(self, ref: TorchMultiD):
        super().__init__()
        for i in range(ref.num_d):
            layers = [m for j in range(ref.n_layers + 2)
                      for m in getattr(ref, f"scale{i}_layer{j}")]
            setattr(self, f"layer{i}", torch.nn.Sequential(*layers))


@pytest.mark.parametrize("interm", [True, False])
def test_discriminator_conversion_equals_the_jax_chain(interm, rng_np):
    """convert_discriminator_state_dict bit for bit against the JAX tool +
    convert.jax_to_torch_discriminator, for both reference layouts, and the
    port's D with those weights against the reference modules."""
    torch.manual_seed(3)
    ref = TorchMultiD(4, ndf=8, n_layers=3, num_d=2)
    sd = (ref if interm else _FlatD(ref)).state_dict()
    got = tool.convert_discriminator_state_dict(sd, 3, 2, interm)
    want = jax_to_torch_discriminator(jtool.convert_discriminator_state_dict(
        {k: v.numpy() for k, v in sd.items()}, 3, 2, interm))
    _bit_equal(got, want)
    net = build_discriminator(4, 8, 3, use_sigmoid=False, num_d=2,
                              get_interm_feat=True, device="cpu")
    net.load_state_dict(got)
    x = torch.from_numpy((rng_np.standard_normal((2, 4, 32, 32)) * 0.5)
                         .astype(np.float32))
    ref.eval()
    with torch.no_grad():
        for gs, ws in zip(net(x), ref(x)):
            for g, w in zip(gs, ws):
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4,
                                           rtol=1e-3)


def test_import_cli_checks_keys_and_shapes(tmp_path):
    """A checkpoint of other model flags stops with SystemExit naming the
    reference key the flags look for, the layers they leave unused, or the
    shapes that differ from the port's net."""
    tm, _ = _reference_g("global", seed=2)      # 2 resblocks
    torch.manual_seed(2)
    td = TorchMultiD(4, ndf=8, n_layers=3, num_d=2)
    for name, net in (("g.pth", tm), ("d.pth", td)):
        torch.save(net.state_dict(), str(tmp_path / name))
    argv = ["--pth", str(tmp_path / "g.pth"), "--name", "imp",
            "--checkpoints_dir", str(tmp_path), "--netG", "global", "--ngf",
            "8", "--n_downsample_global", "2", "--input_nc", "2",
            "--output_nc", "2", "--label_nc", "0", "--no_instance",
            "--explicit_encoding", "--ndf", "8"]
    with pytest.raises(SystemExit, match="G checkpoint has no "
                                         "'model.12.conv_block.1.weight'"):
        tool.main(argv + ["--n_blocks_global", "3"])
    with pytest.raises(SystemExit, match="G checkpoint has no "
                                         "'model.11.weight'"):
        tool.main(argv + ["--n_blocks_global", "1"])
    with pytest.raises(SystemExit, match=r"shapes \(got, want\) "
                                         r"\{'ConvIN_0\.Conv_0\.weight': "
                                         r"\(\(2, 8, 7, 7\), \(2, 16, 7, 7\)\)"):
        tool.main(argv + ["--n_blocks_global", "2", "--ngf", "16"])
    with pytest.raises(SystemExit, match="D checkpoint holds 10 layers, the "
                                         "model flags 5"):
        tool.main(argv + ["--n_blocks_global", "2", "--pth_d",
                          str(tmp_path / "d.pth"), "--num_D", "1"])
    assert not (tmp_path / "imp" / "latest_net_G.pth").exists()


def test_import_cli_checkpoint_serves_and_warm_starts(tmp_path, rng_np,
                                                      capsys):
    """The CLI on a reference G and D: it forces --torch_deconv with the
    note; generate --device cpu --torch_deconv serves its latest_net_G.pth
    (the same audio as the JAX chain's converted weights); a training
    system warm-starts from its train state with G and D as imported."""
    from pix2pixhdaudiosr_torch.config import parse_config
    from pix2pixhdaudiosr_torch.system import Pix2PixHDSystem
    from pix2pixhdaudiosr_torch.trainer import init_state
    from pix2pixhdaudiosr_torch.utils.checkpoint import load_train_state

    torch.manual_seed(4)
    tg, td = TorchLocalE(**TOY_G), TorchMultiD(4, ndf=4, n_layers=2, num_d=2)
    torch.save(tg.state_dict(), str(tmp_path / "latest_net_G.pth"))
    torch.save(td.state_dict(), str(tmp_path / "latest_net_D.pth"))
    tool.main(["--pth", str(tmp_path / "latest_net_G.pth"), "--pth_d",
               str(tmp_path / "latest_net_D.pth"), "--name", "imp",
               "--checkpoints_dir", str(tmp_path), *TOY])
    assert "note: enabling --torch_deconv" in capsys.readouterr().out
    expr = str(tmp_path / "imp")

    wav = tmp_path / "in.wav"
    write_wav(str(wav), (rng_np.standard_normal(1500) * 0.2)
              .astype(np.float32), 48000)
    serve = TOY + ["--torch_deconv", "--dataroot", str(wav), "--batchSize",
                   "2", "--no_html", "--device", "cpu", "--checkpoints_dir",
                   str(tmp_path)]
    got = generate.main(serve + ["--name", "g1", "--load_pretrain", expr])
    chain = tmp_path / "chain"
    chain.mkdir()
    from tools.import_torch_checkpoint import convert_generator_state_dict
    torch.save(jax_to_torch_generator(convert_generator_state_dict(
        {k: v.numpy() for k, v in tg.state_dict().items()}, "local", 2, 1,
        1, 1)), str(chain / "latest_net_G.pth"))
    want = generate.main(serve + ["--name", "g2", "--load_pretrain",
                                  str(chain)])
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert np.array_equal(got, want)

    cfg = parse_config(TOY + ["--torch_deconv", "--name", "warm",
                              "--checkpoints_dir", str(tmp_path)],
                       save=False)
    state = init_state(Pix2PixHDSystem(cfg, device="cpu"), seed=9)
    loaded = load_train_state(state, "latest", expr)
    assert "step" in loaded and any(n.startswith("D.") for n in loaded)
    sys_ = state.system
    for key, want_sd in (("G", tool.convert_generator_state_dict(
            tg.state_dict(), "local", 2, 1, 1, 1)),
                         ("D", tool.convert_discriminator_state_dict(
                             td.state_dict(), 2, 2, True))):
        net = sys_.netG_train if key == "G" else sys_.netD
        for name, t in net.state_dict().items():
            assert torch.equal(t, want_sd[name]), (key, name)


def _corpus(d, rng):
    """Three seeded files: 2.9 s, 0.5 s (one short segment) and stereo 1.3 s
    at 48 kHz, written by the JAX package's writer."""
    d.mkdir()
    rate = 48000
    for name, shape in (("a", (int(2.9 * rate),)), ("b", (int(0.5 * rate),)),
                        ("c", (2, int(1.3 * rate)))):
        jwrite_wav(str(d / f"{name}.wav"),
                   rng.uniform(-0.5, 0.5, shape).astype(np.float32), rate)


def _files(d):
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


def test_seg_audio_torch_matches_jax_and_reruns_as_a_no_op(tmp_path, rng_np,
                                                           capsys):
    """A first run writes the JAX tool's files bit for bit; a second run
    without --delete writes nothing (the JAX tool copies each segment
    again as <segment>000.wav); a --delete run leaves the JAX tool's
    segments, and a re-run on them skips every run of two or more (a lone
    <base>000.wav is a source to it); names ending in 3 digits that no run
    from 000 holds (VCTK's p225_001.wav) are sources."""
    _corpus(tmp_path / "j", rng_np)
    (tmp_path / "t").mkdir()
    for p, data in _files(tmp_path / "j").items():
        (tmp_path / "t" / p).write_bytes(data)
    seg_audio.main([str(tmp_path / "j")])
    assert seg_audio_torch.main([str(tmp_path / "t")]) == 6
    first = _files(tmp_path / "t")
    assert first == _files(tmp_path / "j")
    assert sorted(first) == ["a.wav", "a000.wav", "a001.wav", "a002.wav",
                             "b.wav", "b000.wav", "c.wav", "c000.wav",
                             "c001.wav"]
    assert seg_audio_torch.main([str(tmp_path / "t")]) == 0
    assert _files(tmp_path / "t") == first
    seg_audio.main([str(tmp_path / "j")])
    assert "a000000.wav" in _files(tmp_path / "j")   # the JAX tool's defect

    for d in ("jd", "td"):
        _corpus(tmp_path / d, np.random.default_rng(5))
    seg_audio.main([str(tmp_path / "jd"), "--delete"])
    assert seg_audio_torch.main([str(tmp_path / "td"), "--delete"]) == 6
    done = _files(tmp_path / "td")
    assert done == _files(tmp_path / "jd") and "a.wav" not in done
    assert seg_audio_torch.main([str(tmp_path / "td")]) == 1
    assert sorted(set(_files(tmp_path / "td")) - set(done)) == ["b000000.wav"]

    vctk = tmp_path / "vctk"
    vctk.mkdir()
    for i in (1, 2, 3):
        write_wav(str(vctk / f"p225_{i:03d}.wav"),
                  np.zeros(48000 + 999 * i, np.float32), 48000)
    assert not seg_audio_torch.own_outputs([str(p) for p in vctk.iterdir()],
                                           1.2)
    capsys.readouterr()


def test_seg_audio_torch_reads_a_run_once(tmp_path, monkeypatch, capsys):
    """A re-run on what a --delete run left (one source, 200 segments)
    writes nothing and reads each segment's header once, not once for
    every segment of its run."""
    d = tmp_path / "long"
    d.mkdir()
    write_wav(str(d / "x.wav"), np.zeros(200 * 80 - 30, np.float32), 8000)
    assert seg_audio_torch.main([str(d), "--seconds", "0.01",
                                 "--delete"]) == 200
    reads = []
    info = seg_audio_torch.wav_info
    monkeypatch.setattr(seg_audio_torch, "wav_info",
                        lambda p: reads.append(p) or info(p))
    assert seg_audio_torch.main([str(d), "--seconds", "0.01"]) == 0
    assert sorted(reads) == sorted(str(p) for p in d.iterdir())
    capsys.readouterr()


def test_split_dataset_torch_matches_jax(tmp_path, rng_np):
    """The same train.csv and test.csv as the JAX tool on one corpus and
    seed, paths relative to the csv directory."""
    from tools.split_dataset import main as jmain
    from tools.split_dataset_torch import main
    from pix2pixhdaudiosr_torch.data.filelist import discover_files
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(10):
        write_wav(str(d / f"p225_{i:03d}.wav"),
                  rng_np.uniform(-0.5, 0.5, 1000).astype(np.float32), 8000)
    jmain([str(d), "--test", "3", "--out", str(tmp_path / "j")])
    main([str(d), "--test", "3", "--out", str(tmp_path / "t")])
    for name in ("train.csv", "test.csv"):
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())
    train = (tmp_path / "t" / "train.csv").read_text().splitlines()
    assert len(train) == 7
    assert all(os.path.exists(p)
               for p in discover_files(str(tmp_path / "t" / "train.csv")))


def test_steptimer_warmup_skip_and_summary():
    st = StepTimer(warmup=2)
    for _ in range(5):
        st.start()
        st.stop()
    s = st.summary()
    assert s["steps"] == 3  # first `warmup` laps discarded
    assert 0 <= s["p50_ms"] <= s["p95_ms"]
    assert s["mean_ms"] >= 0


def test_steptimer_empty_and_unbalanced_stop():
    st = StepTimer()
    st.stop()  # stop without start is a no-op, not an error
    assert st.summary() == {}


def test_trace_falls_back_when_profiler_unavailable(monkeypatch, capsys,
                                                    tmp_path):
    import torch.profiler

    class Boom:
        def __init__(self, *args, **kwargs):
            raise RuntimeError("the profiler cannot start")

    monkeypatch.setattr(torch.profiler, "profile", Boom)
    with trace(str(tmp_path / "unused")) as prof:
        assert prof is None  # must not raise
    assert "falling back" in capsys.readouterr().out
    assert not (tmp_path / "unused").exists()


def test_trace_real_backend(tmp_path):
    """The CPU profiler starts and stops, leaves a Chrome trace in the
    directory, and yields a profiler whose events hold a span of the
    traced work (the generate CLI's stages are such spans)."""
    with trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("generate.serve"):
            torch.ones(4).add_(1)
    assert any(tmp_path.iterdir())
    assert "generate.serve" in {e.name for e in prof.events()}


def test_aot_engine_runs_on_the_card_unless_asked(monkeypatch):
    """Without --device the tool asks for CUDA and stops where there is
    none: it never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        aot_main(["--tiny"])


def test_aot_engine_tiny_end_to_end(tmp_path, capsys):
    """--tiny --device cpu --out prints the JAX tool's line heads; the
    engine reloads to eager's bits, and loads and runs in a process where
    jax cannot be imported and only pix2pixhdaudiosr_torch is."""
    out = tmp_path / "engine.pt2"
    res = aot_main(["--tiny", "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    for head in ("compile: ", "cost analysis: {'flops': ",
                 "memory analysis:", "ms/call @ batch 2",
                 "serialized engine -> ", "bit-equal: True"):
        assert head in printed
    assert res["flops"] > 0 and out.stat().st_size > 0
    torch.save({"audio": res["audio"], "noise": res["noise"]},
               str(tmp_path / "in.pt"))
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import torch, pix2pixhdaudiosr_torch\n"
        f"ep = torch.export.load({str(out)!r})\n"
        f"x = torch.load({str(tmp_path / 'in.pt')!r})\n"
        "y = ep.module()(x['audio'], x['noise'])\n"
        f"torch.save(y, {str(tmp_path / 'out.pt')!r})\n"
        "assert not [m for m in sys.modules if m.startswith("
        "('pix2pixhdaudiosr_tpu', 'tools')) and sys.modules[m]]\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    assert torch.equal(torch.load(str(tmp_path / "out.pt")), res["eager_out"])
