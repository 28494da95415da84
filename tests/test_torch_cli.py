"""The port's command line (`libfm_tpu_torch.cli`) against the JAX
package's (`libfm_tpu.cli`), on the CPU.

- the parser: every option's dest, default, type and choices;
- SGD (regression and -task c) and SGDA (-validation, a two-group -meta)
  from one model file written by JAX's save_model_text: the Final line,
  -out and the rlog's metric columns within 1e-5 (plus the 6 significant
  digits both print);
- ALS with -dim 1,0,4 (w = 0, so the warm start leaves nothing drawn),
  -load_model and -num_eval_cases at half the test rows, flat and with
  -relation on binary relation files: the #Iter readings, -out and the
  -save_model file within 1e-4;
- the port's MCMC command line, vector and exact engines, regression and
  -task c, equal bit for bit to its learner run in process; so is the
  pure linear model (-dim 1,1,0) through MCMC and ALS on both engines;
- help and exit codes, the MCMC model-file guard, the refused options
  (each names its ROADMAP item and writes nothing), the CUDA default and
  -profile.

Five JAX CLI runs in all (~1-2 minutes, their compiles most of it).
"""

import os
import re

import numpy as np
import pytest
import torch

from libfm_tpu import cli as jcli
from libfm_tpu.models import fm as jfm
from libfm_tpu_torch import cli
from libfm_tpu_torch.data import binary as tbin
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.relation import RelationData, RelationJoin
from libfm_tpu_torch.data.synth import movielens_like
from libfm_tpu_torch.learners.mcmc import MCMCLearner
from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig

NU, NI = 40, 30
ITER_RE = re.compile(r"^#Iter=\s*(\d+)\tTrain=(\S+)\tTest=(\S+)", re.M)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Text train / test / validation files, a two-group -meta file, and a
    relational form of the same ratings: the users one-hot in the main
    table, each item's row (its one-hot and two of five genres, its groups
    in `.groups`) in a binary relation block joined by binary maps."""
    d = tmp_path_factory.mktemp("cli")
    train, test = movielens_like(num_users=NU, num_items=NI, num_ratings=1500, seed=6)
    p = {key: str(d / f"c.{key}") for key in ("train", "test", "meta")}
    train.to_libfm_text(p["train"])
    test.to_libfm_text(p["test"])
    np.savetxt(p["meta"], np.r_[np.zeros(NU), np.ones(NI)].astype(int), fmt="%d")
    rng = np.random.default_rng(3)
    genres = np.stack([rng.choice(5, 2, replace=False) for _ in range(NI)])
    icols = np.concatenate([np.arange(NI)[:, None], NI + np.sort(genres, axis=1)],
                           axis=1).astype(np.int32)
    ivals = np.tile(np.array([1.0, 0.5, 0.5], np.float32), (NI, 1))
    rel = str(d / "item")
    RelationData(np.arange(NI + 1, dtype=np.int64) * 3, icols.ravel(), ivals.ravel(),
                 NI + 5).save(rel)
    np.savetxt(rel + ".groups", np.r_[np.zeros(NI), np.ones(5)].astype(int), fmt="%d")
    for name, ds in (("train", train), ("test", test)):
        users, items = ds.cols[0::2], ds.cols[1::2] - NU
        main = Dataset(np.arange(ds.num_rows + 1, dtype=np.int64), users.copy(),
                       np.ones(ds.num_rows, np.float32), ds.target, NU)
        main.to_libfm_text(str(d / f"r.{name}"))
        tbin.write_dvector_binary(f"{rel}.{name}", items.astype(np.uint32))
    p.update(rtrain=str(d / "r.train"), rtest=str(d / "r.test"), rel=rel, dir=d,
             ntest=test.num_rows)
    return p


def _readings(text):
    return np.array([[float(m[1]), float(m[2])] for m in ITER_RE.findall(text)])


def _rlog(path):
    lines = open(path).read().splitlines()
    head = lines[0].split("\t")
    return {h: np.array([float(r.split("\t")[i]) for r in lines[1:]])
            for i, h in enumerate(head)}


def _final(text):
    m = re.search(r"^Final\tTrain=(\S+)\tTest=(\S+)$", text, re.M)
    return np.array([float(m[1]), float(m[2])])


def _close(got, want, tol):
    """Within `tol`, beyond the 6 significant digits both sides print."""
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=tol)


def _both(argv, capsys, d, tag, outs=("out", "rlog", "save_model")):
    """Run `argv` (with per-package output files) through JAX's CLI and the
    port's on the CPU; returns {"jax": ..., "port": ...} with the stdout and
    the output paths."""
    res, runs = {}, []
    for name, main in (("jax", jcli.main),
                       ("port", lambda a: cli.main(a, device="cpu", runs=runs))):
        paths = {o: str(d / f"{tag}_{name}.{o}") for o in outs}
        args = list(argv)
        for o, path in paths.items():
            args += [f"-{o}", path]
        capsys.readouterr()
        assert main(args) == 0
        res[name] = dict(paths, stdout=capsys.readouterr().out)
    res["port"]["learner"] = runs[0]
    return res


def test_parser_matches_jax():
    def actions(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required,
                         a.nargs)
                for a in parser._actions if a.dest != "help"}

    got, want = actions(cli.build_parser()), actions(jcli.build_parser())
    assert got == want
    assert len(got) == 29


def _jax_model(d, n, k, seed=3, use_linear=True):
    """A model file written by the JAX package from its seeded init."""
    import jax

    cfg = jfm.FMConfig(num_features=n, num_factors=k, use_linear=use_linear)
    params = jfm.init_fm(cfg, jax.random.PRNGKey(seed))
    params = jfm.FMParams(w0=params.w0 + 3.0, w=params.w + 0.01, v=params.v)
    path = str(d / f"jax_init_{n}_{k}_{seed}.model")
    jfm.save_model_text(params, cfg, path)
    return path


@pytest.mark.parametrize("task", ["r", "c"])
def test_sgd_cli_matches_jax(task, files, capsys):
    d = files["dir"]
    model = _jax_model(d, NU + NI, 4)
    argv = ["-task", task, "-train", files["train"], "-test", files["test"],
            "-method", "sgd", "-dim", "1,1,4", "-learn_rate", "0.01",
            "-regular", "0,0.01,0.02", "-iter", "3", "-seed", "1", "-batch_size", "256",
            "-load_model", model, "-verbosity", "1"]
    res = _both(argv, capsys, d, f"sgd_{task}", outs=("out", "rlog"))
    j, p = res["jax"], res["port"]
    _close(_final(p["stdout"]), _final(j["stdout"]), 1e-5)
    _close(np.loadtxt(p["out"]), np.loadtxt(j["out"]), 1e-5)
    rj, rp = _rlog(j["rlog"]), _rlog(p["rlog"])
    assert list(rp) == list(rj)
    for col in ("rmse", "mae", "rmse_train") if task == "r" else ("accuracy", "rmse_train"):
        _close(rp[col], rj[col], 1e-5)
    assert len(rp["rmse_train"]) == 3 and np.isfinite(rp["time_learn4"]).all()
    # -verbosity's dump (libfm.cpp:409-412) line for line, up to the memory report
    dump = [line for line in j["stdout"].splitlines()
            if "=" in line and not line.startswith(("#Iter", "#mem", "Final"))]
    assert dump == [line for line in p["stdout"].splitlines()
                    if "=" in line and not line.startswith(("#Iter", "#mem", "Final"))]
    if task == "c":
        assert ((np.loadtxt(p["out"]) >= 0) & (np.loadtxt(p["out"]) <= 1)).all()


def test_sgda_cli_matches_jax(files, capsys):
    """SGDA with a validation set and the -meta file's two groups (users,
    items), each learning its own regularizers."""
    d = files["dir"]
    model = _jax_model(d, NU + NI, 3, seed=4)
    argv = ["-task", "r", "-train", files["train"], "-test", files["test"],
            "-validation", files["test"], "-meta", files["meta"], "-method", "sgda",
            "-dim", "1,1,3", "-learn_rate", "0.01", "-iter", "3", "-seed", "1",
            "-batch_size", "256", "-load_model", model]
    res = _both(argv, capsys, d, "sgda", outs=("out", "rlog"))
    j, p = res["jax"], res["port"]
    _close(_final(p["stdout"]), _final(j["stdout"]), 1e-5)
    _close(np.loadtxt(p["out"]), np.loadtxt(j["out"]), 1e-5)
    rj, rp = _rlog(j["rlog"]), _rlog(p["rlog"])
    assert list(rp) == list(rj) and "rmse_val" in rp
    for col in ("rmse", "rmse_train", "rmse_val"):
        _close(rp[col], rj[col], 1e-5)


def _model_text(path):
    """(the section headers, every value) of a model text file."""
    lines = open(path).read().splitlines()
    return ([line for line in lines if line.startswith("#")],
            np.array([float(x) for line in lines if not line.startswith("#")
                      for x in line.split(" ")]))


def _als_readings_match(res, tol):
    j, p = res["jax"], res["port"]
    for r in (j, p):  # both took the warm start
        assert "Reading FM model" in r["stdout"] and "malformed" not in r["stdout"]
    _close(_readings(p["stdout"]), _readings(j["stdout"]), tol)
    _close(np.loadtxt(p["out"]), np.loadtxt(j["out"]), tol)
    (hp, vp), (hj, vj) = _model_text(p["save_model"]), _model_text(j["save_model"])
    assert hp == hj and vp.shape == vj.shape
    _close(vp, vj, tol)


def test_als_cli_matches_jax(files, capsys):
    """Flat ALS from a JAX model file (w0 and V; -dim 1,0,4 keeps w at 0),
    the metrics over the first half of the test rows (-num_eval_cases)."""
    d = files["dir"]
    model = _jax_model(d, NU + NI, 4, seed=5, use_linear=False)
    half = files["ntest"] // 2
    argv = ["-task", "r", "-train", files["train"], "-test", files["test"],
            "-method", "als", "-dim", "1,0,4", "-regular", "0,2,2", "-iter", "3",
            "-seed", "1", "-load_model", model, "-num_eval_cases", str(half)]
    res = _both(argv, capsys, d, "als")
    _als_readings_match(res, 1e-4)
    # the eval prefix: the readings are over the first half of the rows only
    learner = res["port"]["learner"]
    err = learner.predict() - Dataset.load(files["test"]).target
    rmse_this = learner.history[-1]["test_this"]
    assert abs(rmse_this - np.sqrt(np.mean(err[:half] ** 2))) < 1e-6
    assert abs(rmse_this - np.sqrt(np.mean(err ** 2))) > 1e-4


def test_als_relation_cli_matches_jax(files, capsys):
    """ALS with -relation: the users in the main table, the items' block in
    binary files with its own two groups, joined by binary maps."""
    d = files["dir"]
    n = NU + NI + 5
    model = _jax_model(d, n, 4, seed=6, use_linear=False)
    half = files["ntest"] // 2
    argv = ["-task", "r", "-train", files["rtrain"], "-test", files["rtest"],
            "-relation", files["rel"], "-method", "als", "-dim", "1,0,4",
            "-regular", "0,2,2", "-iter", "3", "-seed", "1", "-load_model", model,
            "-num_eval_cases", str(half), "-verbosity", "1"]
    res = _both(argv, capsys, d, "als_rel")
    assert f"num_attributes={n}" in res["port"]["stdout"]
    _als_readings_match(res, 1e-4)


def _twin(cls, files, task, engine_kw, k=4, **learner_kw):
    train, test = Dataset.load(files["train"]), Dataset.load(files["test"])
    if task == "c":
        train.binarize_targets()
        test.binarize_targets()
    n = max(train.num_features, test.num_features)
    learner = cls(FMConfig(num_features=n, num_factors=k), task=int(task == "c"),
                  num_iter=4, num_eval_cases=None, seed=7, attr_group=np.zeros(n, np.int32),
                  verbose=False, device="cpu", **engine_kw, **learner_kw)
    learner.set_regularization([], 1)
    learner.learn(train, test)
    return learner


@pytest.mark.parametrize("engine", ["vector", "exact"])
@pytest.mark.parametrize("task", ["r", "c"])
def test_mcmc_cli_equals_in_process_learner(engine, task, files):
    d = files["dir"]
    out = str(d / f"mcmc_{engine}_{task}.out")
    rlog = str(d / f"mcmc_{engine}_{task}.rlog")
    runs = []
    assert cli.main(["-task", task, "-train", files["train"], "-test", files["test"],
                     "-method", "mcmc", "-engine", engine, "-dim", "1,1,4", "-iter", "4",
                     "-seed", "7", "-out", out, "-rlog", rlog], device="cpu", runs=runs) == 0
    got = runs[0]
    cls, kw = ((MCMCVectorLearner, dict(refresh_every=None)) if engine == "vector"
               else (MCMCLearner, {}))
    assert type(got) is cls
    want = _twin(cls, files, task, kw)
    strip = [{k: v for k, v in h.items() if k != "time"} for h in got.history]
    assert strip == [{k: v for k, v in h.items() if k != "time"} for h in want.history]
    for key in ("w0", "w", "V", "alpha", "w_mu", "v_lambda", "pred_sum_all"):
        assert torch.equal(got._final_state[key], want._final_state[key]), key
    np.testing.assert_allclose(np.loadtxt(out), want.predict(), rtol=5e-6, atol=1e-7)
    # the rlog: a row an iteration, its metrics the run's, the hyperpriors
    # the final state's at the last row
    log = _rlog(rlog)
    metric = "rmse" if task == "r" else "accuracy"
    _close(log[metric], [h["test_all"] for h in got.history], 0)
    _close(log["alpha"], [h["alpha"] for h in got.history], 0)
    last = got._final_state
    _close([log[f"vlambda[0,{f}]"][-1] for f in range(4)], last["v_lambda"][0].numpy(), 0)
    _close(log["wmu[0]"][-1], last["w_mu"][0].item(), 1e-12)


@pytest.mark.parametrize("engine", ["vector", "exact"])
@pytest.mark.parametrize("method", ["mcmc", "als"])
def test_linear_model_cli_equals_in_process_learner(engine, method, files):
    """-dim 1,1,0, the pure linear model, on flat data: the same readings
    and final bits as the learner run in process with k = 0."""
    runs = []
    assert cli.main(["-task", "r", "-train", files["train"], "-test", files["test"],
                     "-method", method, "-engine", engine, "-dim", "1,1,0", "-iter", "4",
                     "-seed", "7"], device="cpu", runs=runs) == 0
    got = runs[0]
    cls, kw = ((MCMCVectorLearner, dict(refresh_every=None)) if engine == "vector"
               else (MCMCLearner, {}))
    als = dict(do_sample=False, do_multilevel=False) if method == "als" else {}
    want = _twin(cls, files, "r", kw, k=0, **als)
    strip = [{k: v for k, v in h.items() if k != "time"} for h in got.history]
    assert strip == [{k: v for k, v in h.items() if k != "time"} for h in want.history]
    assert got._final_state["V"].shape[1] == 0
    for key in ("w0", "w", "alpha", "pred_sum_all"):
        assert torch.equal(got._final_state[key], want._final_state[key]), key


def test_help_and_exit_codes(capsys):
    assert cli.main([]) == 0
    assert "usage" in capsys.readouterr().out
    assert cli.main(["-task", "r"]) == 1
    assert cli.main(["-task", "r", "-train", "/nonexistent"]) == 1


USAGE = {
    "unknown_method": ["-method", "gibbs"],
    "unknown_task": ["-task", "x"],
    "dim_of_two": ["-dim", "1,8"],
    "two_learn_rates": ["-method", "sgd", "-learn_rate", "0.1,0.2"],
    "sgd_regular_of_two": ["-method", "sgd", "-regular", "0.1,0.2"],
    "sgda_without_validation": ["-method", "sgda"],
}


@pytest.mark.parametrize("case", USAGE)
def test_usage_errors_exit_1_before_loading(case, files, capsys):
    """The JAX CLI's assertions on the flags' values, as exit code 1 with
    an ERROR line before any data loads."""
    argv = ["-task", "r", "-train", files["train"], "-test", files["test"], "-iter", "1"]
    assert cli.main(argv + USAGE[case], device="cpu") == 1
    text = capsys.readouterr().out
    assert text.startswith("ERROR") and "Loading" not in text


@pytest.mark.parametrize("flag", ["-save_model", "-load_model"])
def test_mcmc_model_file_guard_returns_0_without_training(flag, files, capsys):
    path = str(files["dir"] / f"guard{flag}.txt")
    out = str(files["dir"] / f"guard{flag}.out")
    assert cli.main(["-task", "r", "-train", files["train"], "-test", files["test"],
                     "-method", "mcmc", flag, path, "-out", out], device="cpu") == 0
    assert "enabled only for SGD and ALS" in capsys.readouterr().out
    assert not os.path.exists(out)
    if flag == "-save_model":
        assert not os.path.exists(path)


def _binary_pair(files):
    prefix = str(files["dir"] / "bin")
    if not os.path.exists(prefix + ".xt"):
        Dataset.load(files["train"]).to_binary(prefix + ".train", with_transpose=False)
        Dataset.load(files["train"]).to_binary(prefix, with_transpose=True)
    return prefix


REFUSED = {
    "mesh": (["-mesh", "2"], "item 6"),
    "distributed": (["-distributed", "1"], "item 6"),
    "float64": (["-dtype", "float64"], "item 5"),
    "bfloat16": (["-dtype", "bfloat16"], "item 5"),
    "k0_relation": (["-relation", "{rel}", "-dim", "1,1,0"], "item 2"),
    "k0_sgd": (["-method", "sgd", "-dim", "1,1,0"], "item 2"),
    "k0_sgda": (["-method", "sgda", "-validation", "{test}", "-dim", "1,1,0"], "item 2"),
}


@pytest.mark.parametrize("case", REFUSED)
def test_refused_options_name_their_roadmap_item(case, files, capsys):
    extra, item = REFUSED[case]
    extra = [a.format(bin=_binary_pair(files), rel=files["rel"], test=files["test"])
             for a in extra]
    outs = {o: str(files["dir"] / f"refused_{case}.{o}") for o in ("out", "rlog", "save_model")}
    argv = ["-task", "r", "-train", files["train"], "-test", files["test"], "-method", "als",
            "-iter", "1"]
    argv += extra + [a for o, p in outs.items() for a in (f"-{o}", p)]
    assert cli.main(argv, device="cpu") == 1
    text = capsys.readouterr().out
    assert f"ROADMAP §1 {item}" in text and text.startswith("ERROR")
    assert "Loading" not in text
    assert not any(os.path.exists(p) for p in outs.values())


def _binary(files, name, with_transpose=False):
    """The binary pair (and with `with_transpose` the .xt) of the text
    file files[name], under a prefix of its own."""
    prefix = str(files["dir"] / f"bin_{name}{'_t' if with_transpose else ''}")
    if not os.path.exists(prefix + ".x"):
        Dataset.load(files[name]).to_binary(prefix, with_transpose=with_transpose)
    return prefix


#: -cache_size runs that read a set out of core: (the command line's
#: method flags and data, the message the streamed run prints)
STREAMED = {
    "sgd": (["-method", "sgd", "-train", "{train}"], ["Training out-of-core"]),
    "sgda": (["-method", "sgda", "-train", "{train}", "-validation", "{validation}",
              "-meta", "{meta}"], ["Training out-of-core", "Validation out-of-core"]),
    "als_xt": (["-method", "als", "-train", "{train_t}"], ["Training out-of-core"]),
    "mcmc_test_set": (["-method", "mcmc", "-test", "{test}"], ["Test set out-of-core"]),
    "relation": (["-method", "als", "-train", "{rtrain}", "-test", "{rtest}", "-relation",
                  "{rel}"], ["NOTE: -relation with -cache_size"]),
}


@pytest.mark.parametrize("case", STREAMED)
def test_cache_size_streams_as_the_resident_run(case, files, capsys):
    """A set read out of core under -cache_size gives the resident run's
    -out file and iteration readings (the same batches or blocks, the same
    bits); SGD and SGDA then print no train metric, as the JAX CLI."""
    extra, said = STREAMED[case]
    paths = dict(train=_binary(files, "train"), train_t=_binary(files, "train", True),
                 test=_binary(files, "test"), validation=_binary(files, "test"),
                 meta=files["meta"], rtrain=_binary(files, "rtrain", True),
                 rtest=_binary(files, "rtest"), rel=files["rel"])
    argv = ["-task", "r", "-train", files["train"], "-test", files["test"], "-dim", "1,1,3",
            "-iter", "3", "-seed", "3", "-learn_rate", "0.01", "-regular", "0,0,0.01"]
    argv += [a.format(**paths) for a in extra]
    outs = {}
    for budget in (None, "100"):
        out = str(files["dir"] / f"streamed_{case}_{budget}.out")
        runs = []
        capsys.readouterr()
        assert cli.main(argv + ["-out", out] + (["-cache_size", budget] if budget else []),
                        device="cpu", runs=runs) == 0
        text = capsys.readouterr().out
        outs[budget] = (open(out).read(), [m[0] for m in ITER_RE.findall(text)]
                        or re.findall(r"^#Iter=\s*\d+\tTest=(\S+)", text, re.M), text)
        assert all((s in text) == bool(budget) for s in said)
    (want, want_it, _), (got, got_it, text) = outs[None], outs["100"]
    assert got == want and len(want.splitlines()) == files["ntest"]
    if case in ("sgd", "sgda"):
        assert "Final\tTest=" in text and "Final\tTrain" not in text
        want_it = [m[2] for m in ITER_RE.findall(outs[None][2])]
    assert got_it == want_it and len(want_it) == 3


def test_cache_size_within_budget_loads_resident(files, capsys):
    prefix = _binary_pair(files)
    assert cli.main(["-task", "r", "-train", prefix + ".train", "-test", files["test"],
                     "-method", "sgd", "-dim", "1,1,2", "-iter", "1", "-cache_size", "1e12"],
                    device="cpu") == 0
    assert "Final" in capsys.readouterr().out


def test_default_device_is_cuda_and_never_the_cpu(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(files["dir"] / "nodevice.out")
    assert cli.main(["-task", "r", "-train", files["train"], "-test", files["test"],
                     "-method", "sgd", "-iter", "1", "-out", out]) == 1
    text = capsys.readouterr().out
    assert "no CUDA device" in text and "#Iter" not in text and "Loading" not in text
    assert not os.path.exists(out)


def test_profile_writes_a_trace(files, tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["-task", "r", "-train", files["train"], "-test", files["test"],
                     "-method", "sgd", "-dim", "1,1,2", "-iter", "1", "-profile", str(prof)],
                    device="cpu") == 0
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1 and '"traceEvents"' in traces[0].read_text()[:4096]


def test_convert_tool_matches_jax(files, tmp_path):
    from libfm_tpu.tools import convert as jconvert
    from libfm_tpu_torch.tools import convert

    for tool, tag in ((convert, "t"), (jconvert, "j")):
        assert tool.main(["--ifile", files["train"], "--ofilex", str(tmp_path / f"{tag}.x"),
                          "--ofiley", str(tmp_path / f"{tag}.y")]) == 0
    for suf in (".x", ".y"):
        assert (tmp_path / f"t{suf}").read_bytes() == (tmp_path / f"j{suf}").read_bytes()
    rows = Dataset.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(rows.cols, Dataset.load(files["train"]).cols)


def test_relation_files_load_as_the_cli_joins_them(files):
    """The relational files of the fixture, loaded as the CLI loads them,
    join back to the flat ratings."""
    rd = RelationData.load(files["rel"])
    assert rd.meta.num_attr_groups == 2
    main = Dataset.load(files["rtrain"])
    join = RelationJoin.load(rd, files["rel"] + ".train", main.num_rows)
    flat = Dataset.load(files["train"])
    np.testing.assert_array_equal(join.row_map, flat.cols[1::2] - NU)
