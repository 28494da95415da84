"""The command line of the port, with libFM's flag set.

    python -m libfm_tpu_torch.cli -task r -train ml.train -test ml.test \\
        -method mcmc -dim 1,1,64 -iter 100 -out preds.txt -rlog log.tsv

The port's counterpart of `libfm_tpu.cli` (libFM src/libfm/libfm.cpp:
62-441): the same flags, defaults (method=mcmc, dim=1,1,8,
init_stdev=0.1, iter=100, learn_rate=0.1), file formats and outputs,
driving the port's learners on CUDA (`main(argv, device="cpu")` runs the
plain versions of the kernels on the CPU, as the tests do). The same
rules as libFM's:

- `als` is mcmc with do_sampling=0 do_multilevel=0 (libfm.cpp:135-139);
- -save_model / -load_model with mcmc warn and exit 0 without training
  (libfm.cpp:123-133);
- classification targets become +-1 (libfm.cpp:302-305);
- -regular takes 0/1/3 values for SGD and 0/1/3/(1+2G) for MCMC/ALS
  (libfm.cpp:326-385), -learn_rate 1 or 3 (libfm.cpp:386-404).

Data files load in libFM's binary formats or its text format
(`Dataset.load`); `tools/convert.py` makes the binary ones. Under
-cache_size (bytes) a binary `.x` larger than the budget is read out of
core (`data.streaming.StreamingDataset`, windows of max(1024, budget / 8)
entries), where the JAX package reads it so: SGD's and SGDA's train set
(`learn_stream`) and SGDA's validation set; MCMC's and ALS's train set
where its transpose `.xt` lies beside it (`tools/transpose.py` makes it;
without it a warning, and the set loads resident) and their test set
unless -relation is given. With -relation the main table and the relation
blocks load resident (the BS engines hold them whole). What the port does
not take yet is refused before any data loads, with the ROADMAP item it
waits for: -mesh and -distributed 1 (M13, §1 item 6), -dtype other than
float32 (§1 item 5), and the pure linear model (-dim with k = 0) with
-relation, -method sgd or sgda (§1 item 2; with mcmc and als on flat
data it runs).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np


def _split_list(s: str) -> list[str]:
    # libFM splits on ';' and ',' (src/util/cmdline.h:203-236)
    out = []
    for part in s.replace(";", ",").split(","):
        part = part.strip()
        if part:
            out.append(part)
    return out


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser: the same option strings, dests, defaults,
    types and choices."""
    p = argparse.ArgumentParser(
        prog="libfm-torch",
        description="factorization machines on CUDA (libFM's capability set; "
        "the PyTorch port of libfm_tpu)",
    )
    a = p.add_argument
    a("-task", required=False, help="r=regression, c=binary classification")
    a("-train", required=False, help="filename for training data")
    a("-test", required=False, help="filename for test data")
    a("-validation", default=None, help="filename for validation data (SGDA)")
    a("-meta", default=None, help="filename for meta information (groups)")
    a("-dim", default="1,1,8", help="'k0,k1,k2' bias, 1-way, factor dim")
    a("-regular", default="", help="'r0,r1,r2' regularization")
    a("-init_stdev", type=float, default=0.1)
    a("-iter", type=int, default=100)
    a("-learn_rate", default="0.1")
    a("-method", default="mcmc", help="sgd, sgda, als, mcmc")
    a("-verbosity", type=int, default=0)
    a("-rlog", default=None, help="write per-iteration metrics TSV")
    a("-seed", type=int, default=None)
    a("-out", default=None, help="filename for test predictions")
    a("-relation", default="", help="BS: filenames for relations")
    a(
        "-cache_size",
        default=None,
        help="host-memory budget in bytes for binary data (libfm.cpp:98): "
        "a binary .x larger than it is read out of core (SGD / SGDA train "
        "and validation; MCMC / ALS train with its .xt beside it, and test)",
    )
    a("-save_model", default=None)
    a("-load_model", default=None)
    a("-do_sampling", type=int, default=1)
    a("-do_multilevel", type=int, default=1)
    a("-num_eval_cases", type=int, default=None)
    # extensions of the JAX package, kept so the flag set is the same
    a("-batch_size", type=int, default=1024)
    a("-dtype", default="float32", choices=["float32", "float64", "bfloat16"],
      help="float32 only on the port (the others wait for ROADMAP §1 item 5)")
    a(
        "-mesh",
        default=None,
        help="device mesh 'data,model': multi-GPU waits for ROADMAP §1 "
        "item 6 (M13) and is refused",
    )
    a(
        "-distributed",
        type=int,
        default=0,
        help="multi-host runs: wait for ROADMAP §1 item 6 (M13); 1 is refused",
    )
    a("-profile", default=None,
      help="write a torch.profiler chrome trace of the training to this dir")
    a(
        "-refresh_every",
        type=int,
        default=None,
        help="vector MCMC/ALS: re-predict the train cache every R-th "
        "iteration (1 = libFM's cadence; default 8: the incremental cache "
        "updates are exact, so the refresh is float-drift control; "
        "fm_learn_mcmc_simultaneous.h:123-124)",
    )
    a(
        "-engine",
        default="vector",
        choices=["vector", "exact"],
        help="MCMC/ALS sweep engine: 'vector' = joint (w_j, v_j) draws "
        "(default; thin relational joins expanded, fat ones on the BS vector "
        "engine); 'exact' = libFM's per-coordinate scan order",
    )
    return p


def _streamed(args, prefix: str, need_transpose: bool = False):
    """A StreamingDataset of `<prefix>.x` / `.y` where -cache_size is given
    and the binary `.x` is larger than it (and, with `need_transpose`, its
    `.xt` exists), else None; its windows hold max(1024, budget // 8)
    entries (JAX cli.py)."""
    if not args.cache_size or not prefix:
        return None
    budget = int(float(args.cache_size))
    xp = prefix + ".x"
    if not (os.path.exists(xp) and os.path.getsize(xp) > budget):
        return None
    if need_transpose and not os.path.exists(prefix + ".xt"):
        return None
    from libfm_tpu_torch.data.streaming import StreamingDataset

    return StreamingDataset(xp, prefix + ".y", entry_budget=max(1024, budget // 8))


def _usage_error(args, method: str) -> str | None:
    """What is wrong with the flags' values (the JAX CLI's assertions),
    or None."""
    if method not in ("sgd", "sgda", "mcmc"):
        return f"unknown method {args.method}"
    if args.task not in ("r", "c"):
        return f"unknown task {args.task!r} (expected 'r' or 'c')"
    if len(_split_list(args.dim)) != 3:
        return "-dim expects 'k0,k1,k2'"
    if len(_split_list(args.learn_rate)) not in (1, 3):
        return "-learn_rate expects 1 or 3 values"
    if method == "sgd" and len(_split_list(args.regular)) not in (0, 1, 3):
        return "-regular expects 0, 1 or 3 values"
    if method == "sgda" and not args.validation:
        return "SGDA requires -validation"
    return None


def _refusal(args, method: str) -> str | None:
    """Why the port refuses the command line, naming the ROADMAP item,
    or None."""
    if args.mesh:
        return "-mesh (multi-GPU) waits for ROADMAP §1 item 6 (M13)"
    if args.distributed:
        return "-distributed 1 (multi-host) waits for ROADMAP §1 item 6 (M13)"
    if args.dtype != "float32":
        return f"-dtype {args.dtype} waits for ROADMAP §1 item 5; the port runs float32"
    if int(_split_list(args.dim)[2]) == 0 and (method in ("sgd", "sgda")
                                              or _split_list(args.relation)):
        where = "-relation" if method == "mcmc" else f"-method {method}"
        return (f"-dim with k = 0 (the pure linear model) with {where} "
                "waits for ROADMAP §1 item 2 (the kernels' range of k)")
    return None


def main(argv=None, device=None, runs: list | None = None) -> int:
    """Run one command line; returns the exit code. `device` None runs on
    CUDA and fails (exit 1) without it, never on the CPU; the tests pass
    device="cpu". A list `runs` gets the run's learner appended, for a
    caller that compares it with an in-process run."""
    args = build_parser().parse_args(argv)
    if not (args.task and args.train and args.test):
        build_parser().print_help()
        # no arguments at all asks for the help (exit 0); anything else
        # missing a required flag is a usage error
        given = sys.argv[1:] if argv is None else list(argv)
        return 0 if not given else 1

    method = args.method.lower()
    seed = args.seed if args.seed is not None else 1
    do_sampling = bool(args.do_sampling)
    do_multilevel = bool(args.do_multilevel)

    # libFM warns and exits 0 WITHOUT training for mcmc with a model file
    # (libfm.cpp:123-133); als passes (the check comes before the rewrite)
    if method == "mcmc" and args.save_model:
        print("WARNING: -save_model enabled only for SGD and ALS.")
        return 0
    if method == "mcmc" and args.load_model:
        print("WARNING: -load_model enabled only for SGD and ALS.")
        return 0
    if method == "als":  # mcmc without sampling and hyperprior inference
        method = "mcmc"
        do_sampling = False
        do_multilevel = False

    why = _usage_error(args, method) or _refusal(args, method)
    if why:
        print(f"ERROR: {why}")
        return 1

    from libfm_tpu_torch.data.dataset import DataMetaInfo, Dataset
    from libfm_tpu_torch.data.relation import RelationData, RelationJoin
    from libfm_tpu_torch.device import resolve_device
    from libfm_tpu_torch.models.fm import FMConfig, load_model_text, save_model_text
    from libfm_tpu_torch.tasks import TASK_CLASSIFICATION, parse_task
    from libfm_tpu_torch.utils.rlog import RLog

    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"ERROR: {e}")
        return 1

    def _debug(ds, name):
        # libFM's Data::debug (src/libfm/src/Data.h:343-356)
        if args.verbosity > 0:
            print(
                f"{name}: num_cases={ds.num_rows}\tnum_values={ds.nnz}\t"
                f"num_features={ds.num_features}\t"
                f"min_target={ds.min_target}\tmax_target={ds.max_target}"
            )

    def out_of_core(what, ds):
        if ds is not None:
            print(f"{what} out-of-core: {ds.x_path} ({os.path.getsize(ds.x_path)} B > "
                  f"cache_size {int(float(args.cache_size))} B)")
        return ds

    # -cache_size: the sets the JAX CLI streams (libFM's LargeSparseMatrixHD,
    # fmatrix.h:165-281; MCMC and ALS read the .xt as libFM reads its data_t
    # file, libfm.cpp:141-174)
    rel_names = _split_list(args.relation)
    stream_train = None
    if method in ("sgd", "sgda"):
        stream_train = _streamed(args, args.train)
    elif args.cache_size:
        stream_train = _streamed(args, args.train, need_transpose=True)
        xp, xtp = args.train + ".x", args.train + ".xt"
        if os.path.exists(xp) and not os.path.exists(xtp):
            print(f"WARNING: -cache_size for MCMC/ALS needs the transpose at {xtp} (build "
                  "it with python -m libfm_tpu_torch.tools.transpose); loading resident.")
    if rel_names and stream_train is not None:
        # the BS engines join against a resident main table and hold the
        # relation blocks whole
        print("NOTE: -relation with -cache_size: the (typically tiny) BS main table "
              "and the relation tables load resident.")
        stream_train = None
    out_of_core("Training", stream_train)
    if stream_train is None:
        print("Loading train...")
        train = Dataset.load(args.train)
        _debug(train, "train")
    else:
        train = stream_train
    test = (out_of_core("Test set", _streamed(args, args.test))
            if method == "mcmc" and not rel_names else None)
    if test is None:
        print("Loading test...")
        test = Dataset.load(args.test)
        _debug(test, "test")
    validation = None
    if args.validation:
        if method != "sgda":
            print(
                "WARNING: Validation data is only used for SGDA. The data "
                "is ignored."
            )
        else:
            if stream_train is not None:
                validation = out_of_core("Validation", _streamed(args, args.validation))
            if validation is None:
                validation = Dataset.load(args.validation)

    relations = []
    rel_budget = max(1024, int(float(args.cache_size)) // 8) if args.cache_size else None
    for rn in rel_names:
        rd = RelationData.load(rn, entry_budget=rel_budget)
        relations.append(rd)
        train.relations.append(RelationJoin.load(rd, rn + ".train", train.num_rows))
        test.relations.append(RelationJoin.load(rd, rn + ".test", test.num_rows))

    # the joined attribute space and its groups (libfm.cpp:199-243)
    num_all_attribute = max(train.num_features, test.num_features)
    if validation is not None:
        num_all_attribute = max(num_all_attribute, validation.num_features)
    # a targets-only file (no features, e.g. a BS main table run without
    # -relation) still needs a parameter table
    num_all_attribute = max(num_all_attribute, 1)
    meta_main = DataMetaInfo(num_all_attribute)
    if args.meta:
        meta_main.load_groups(args.meta)
    for rd in relations:
        rd.attr_offset = num_all_attribute
        num_all_attribute += rd.num_features
    attr_group = np.zeros(num_all_attribute, dtype=np.int32)
    attr_group[: len(meta_main.attr_group)] = meta_main.attr_group
    group_cntr = meta_main.num_attr_groups
    for rd in relations:
        sl = slice(rd.attr_offset, rd.attr_offset + rd.num_features)
        attr_group[sl] = group_cntr + rd.meta.attr_group
        group_cntr += rd.meta.num_attr_groups
    num_groups = group_cntr

    dims = [int(x) for x in _split_list(args.dim)]
    reg = [float(x) for x in _split_list(args.regular)]
    reg3 = (reg * 3)[:3] if len(reg) == 1 else (reg if len(reg) == 3 else [0.0, 0.0, 0.0])

    cfg = FMConfig(
        num_features=num_all_attribute,
        num_factors=dims[2],
        use_bias=dims[0] != 0,
        use_linear=dims[1] != 0,
        init_stdev=args.init_stdev,
        reg0=reg3[0],
        regw=reg3[1],
        regv=reg3[2],
    )

    task = parse_task(args.task)
    if task == TASK_CLASSIFICATION:
        train.binarize_targets()
        test.binarize_targets()
        if validation is not None:
            validation.binarize_targets()

    def maybe_profile():
        if args.profile:
            from libfm_tpu_torch.utils.profiling import trace

            return trace(args.profile)
        return contextlib.nullcontext()

    lr = [float(x) for x in _split_list(args.learn_rate)]
    learn_rates = tuple(lr) if len(lr) == 3 else (lr[0],) * 3

    def _verbosity_dump():
        """fm.debug() + fml->debug() at -verbosity > 0 (libfm.cpp:409-412;
        fm_model.h:80-89, fm_learn.h:107-111, fm_learn_sgd.h:71-74,
        adapt_reg.h:357-360, fm_learn_mcmc.h:1203-1209)."""
        if args.verbosity <= 0:
            return
        print(f"num_attributes={num_all_attribute}")
        print(f"use w0={dims[0]}")
        print(f"use w1={dims[1]}")
        print(f"dim v ={dims[2]}")
        print(f"reg_w0={reg3[0]:g}")
        print(f"reg_w={reg3[1]:g}")
        print(f"reg_v={reg3[2]:g}")
        print(f"init ~ N(0,{args.init_stdev:g})")
        if method == "sgda":
            print("method=sgda")
        if method in ("sgd", "sgda"):
            print(f"num_iter={args.iter}")
        print(f"task={task}")
        print(f"min_target={train.min_target:g}")
        print(f"max_target={train.max_target:g}")
        if method == "mcmc":
            print(f"do_multilevel={int(do_multilevel)}")
            print(f"do_sampling={int(do_sampling)}")
            nec = args.num_eval_cases if args.num_eval_cases is not None else test.num_rows
            print(f"num_eval_cases={nec}")

    with contextlib.ExitStack() as files:
        rlog = None
        if args.rlog:
            rlog = RLog(path=args.rlog)
            files.callback(rlog.close)

        if method in ("sgd", "sgda"):
            if method == "sgd":
                from libfm_tpu_torch.learners.sgd import SGDLearner

                learner = SGDLearner(cfg, task=task, num_iter=args.iter,
                                     learn_rates=learn_rates, batch_size=args.batch_size,
                                     seed=seed, rlog=rlog, device=dev)
            else:
                from libfm_tpu_torch.learners.sgda import SGDALearner

                learner = SGDALearner(cfg, attr_group=attr_group, task=task,
                                      num_iter=args.iter, learn_rates=learn_rates,
                                      batch_size=args.batch_size, seed=seed, rlog=rlog,
                                      device=dev)
            learner.init_params()
            if args.load_model:
                loaded = load_model_text(cfg, args.load_model)
                if loaded is not None:
                    learner.init_params(loaded)
                elif method == "sgd":
                    print("WARNING: malformed model file. Nothing will be loaded.")
            if rlog:
                rlog.init()
            _verbosity_dump()
            with maybe_profile():
                learn = learner.learn_stream if stream_train is not None else learner.learn
                learn(train, test, *([validation] if method == "sgda" else []))
            # the last epoch's metrics are the final parameters' evaluation
            if stream_train is not None:  # no train metric (JAX cli.py)
                te_f = learner.history[-1][1] if learner.history else learner.evaluate(test)
                print(f"Final\tTest={te_f:.6g}")
            else:
                if learner.history:
                    tr_f, te_f = learner.history[-1][0], learner.history[-1][1]
                else:
                    tr_f, te_f = learner.evaluate(train), learner.evaluate(test)
                print(f"Final\tTrain={tr_f:.6g}\tTest={te_f:.6g}")
            preds = learner.predict(test) if args.out else None
            params_out = learner.params
        else:  # mcmc and als
            extra = {}
            if args.engine == "vector":
                # relational (BS) data is routed inside the vector learner: thin
                # joins expanded onto the flat engine, fat ones on the BS engines
                from libfm_tpu_torch.learners.mcmc_vector import (
                    MCMCVectorLearner as MCMCLearner,
                )

                extra["refresh_every"] = args.refresh_every
            else:
                from libfm_tpu_torch.learners.mcmc import MCMCLearner

                if args.refresh_every not in (None, 1):
                    print(
                        "WARNING: -refresh_every applies to the vector "
                        "engine only; ignoring."
                    )
            learner = MCMCLearner(
                cfg,
                task=task,
                num_iter=args.iter,
                do_sample=do_sampling,
                do_multilevel=do_multilevel,
                num_eval_cases=args.num_eval_cases,
                seed=seed,
                rlog=rlog,
                attr_group=attr_group,
                device=dev,
                **extra,
            )
            learner.set_regularization(reg, num_groups)
            if args.load_model:
                # only `als` gets here (the mcmc guard above exits); libFM loads
                # the model (libfm.cpp:262-268) and then re-draws w (:283):
                # the warm start keeps w0 and V
                print("Reading FM model...")
                loaded = load_model_text(cfg, args.load_model)
                if loaded is None:
                    print("WARNING: malformed model file. Nothing will be loaded.")
                else:
                    learner.warm_start = loaded
            learner.register_log_fields()
            if rlog:
                rlog.init()
            _verbosity_dump()
            with maybe_profile():
                learner.learn(train, test)
            preds = learner.predict(test) if args.out else None
            # only `als` passes the guard with -save_model: its parameters are
            # the deterministic final solution
            params_out = learner.get_params() if args.save_model else None
        if runs is not None:
            runs.append(learner)

        if args.verbosity > 0:
            # the end-of-run memory accounting (libFM's MemoryLog, memory.h:31-62)
            from libfm_tpu_torch.utils.profiling import print_peak_memory_report

            print_peak_memory_report()
        if args.out and preds is not None:
            np.savetxt(args.out, preds, fmt="%.6g")
        if args.save_model and params_out is not None:
            print(f"Writing FM model to {args.save_model}")
            save_model_text(params_out, cfg, args.save_model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
