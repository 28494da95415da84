"""Mini-batch SGD learner (PyTorch, one device).

The port of `libfm_tpu.learners.sgd`, libFM's element-wise SGD
(src/libfm/src/fm_learn_sgd_element.h:48-78 with the fm_SGD update,
src/fm_core/fm_sgd.h:33-51) in padded mini-batches: every multiplier of
a batch comes from one parameter snapshot and the per-entry updates are
scatter-added. With batch_size=1 this is the reference's sequential
algorithm; with larger batches it is sum-reduced mini-batch SGD.

An epoch works on the packed table P = [w | V] [n, 1+k]. Per batch:
  sgd_step       (CUDA kernel: gather, prediction, multiplier, update rows
                  in the presorted order, batch sums, w0 in place),
  table_scatter  (CUDA kernel: the rows added in the host-presorted order).
The batches run as a Python loop of two launches each, on buffers and
scratch allocated once an epoch; nothing is copied to the host inside an
epoch. Evaluation and prediction use the fm_refresh kernel
in test mode. On CPU tensors every kernel wrapper runs its plain PyTorch
version.

Per-layer learn rates (`learn_rates=(r0, r1, r2)`) follow libFM
libfm.cpp:386-404. With an `rlog` (utils.rlog.RLog) each epoch writes
one row of the JAX learner's fields. `learn_stream` trains out of core
from a `data.streaming.StreamingDataset`: each epoch streams the rows in
bounded windows and uploads one padded batch at a time, the batches the
resident `learn` makes, through the same two launches each.
"""

from __future__ import annotations

import numpy as np
import torch

from libfm_tpu_torch.data.batching import BatchedCSR, batch_dataset
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.streaming import is_stream
from libfm_tpu_torch.device import resolve_device
from libfm_tpu_torch.kernels.fm_refresh import fm_refresh
from libfm_tpu_torch.kernels.sgd_step import (
    sgd_multiplier,
    sgd_step,
    sgd_step_scratch,
    sgd_w0_update,
)
from libfm_tpu_torch.kernels.table_scatter import ScatterScratch, longest_runs, table_scatter
from libfm_tpu_torch.learners import base
from libfm_tpu_torch.learners.base import RANGE_OF_K
from libfm_tpu_torch.models.fm import FMConfig, FMParams, fm_batch_terms, init_fm
from libfm_tpu_torch.tasks import TASK_REGRESSION
from libfm_tpu_torch.utils.timers import iter_clocks

__all__ = [
    "SGDLearner", "make_epoch_fn", "make_eval_fn", "sgd_batch_update",
    "sgd_multiplier", "sorted_scatter_order",
]

#: the CUDA kernels take 1 <= k <= 128
MAX_FACTORS_CUDA = 128


def sgd_batch_update(params: FMParams, ids, vals, y, row_mask, cfg: FMConfig,
                     lr0, lr1, lr2, task: int, min_target, max_target) -> FMParams:
    """One mini-batch SGD step on separate (w0, w, V) in plain torch;
    returns the updated parameters (the parity anchor of the packed
    epoch)."""
    dt = params.v.dtype
    vals = vals.to(dt)
    pred, vsum = fm_batch_terms(params, ids, vals, cfg)
    mult = sgd_multiplier(pred, y.to(dt), task, min_target, max_target)
    mult = torch.where(row_mask, mult, torch.zeros_like(mult))
    entry_mask = (vals != 0.0).to(dt)
    flat = ids.reshape(-1).long()

    new_w0 = params.w0
    if cfg.use_bias:
        n_real = row_mask.sum().to(dt)
        new_w0 = sgd_w0_update(params.w0, lr0, mult.sum(), n_real, cfg.reg0)
    new_w = params.w
    if cfg.use_linear:
        w_g = params.w[ids.long()]
        gw = mult[:, None] * vals + cfg.regw * w_g * entry_mask
        new_w = params.w.index_add(0, flat, (-lr1 * gw).reshape(-1))
    v_g = params.v[ids.long()]
    gv = mult[:, None, None] * (
        vsum[:, None, :] * vals[..., None] - v_g * (vals * vals)[..., None]
    ) + cfg.regv * v_g * entry_mask[..., None]
    new_v = params.v.index_add(0, flat, (-lr2 * gv).reshape(-1, params.v.shape[1]))
    return FMParams(w0=new_w0, w=new_w, v=new_v)


def _packed(params: FMParams):
    """P = [w | V] [n, 1+k], the table the kernels read."""
    return torch.cat([params.w[:, None], params.v], dim=1).contiguous()


def make_epoch_fn(cfg: FMConfig, task: int, mode: str = "general"):
    """An epoch function over a stack of batches on the packed table.

    epoch(params, ids, vals, y, row_mask, sids, perm, lrs, min_t, max_t,
    max_runs=None) takes the stacked batch tensors ([NB, B, L], [NB, B],
    and the presorted scatter order [NB, B*L]), concatenates P = [w | V],
    runs one sgd_step (with the w0 update) + table_scatter per batch, and
    returns the new FMParams (w and V split back out of P). `max_runs`
    [NB] is each batch's longest run of equal ids (`longest_runs(sids)`,
    which the learner takes once at set-up); when None the epoch takes it
    from sids, a copy to the host.

    Once an epoch it clones w0, inverts the scatter order (`order`, each
    entry's sorted position, so sgd_step writes the update rows in the
    order table_scatter reads them) and allocates the buffers and
    scratch; a batch then costs two wrapper calls and nothing else.

    `mode` ("pair", "onehot", "general") is chosen by `_epoch_mode` from
    the static batch stack."""
    kw = dict(mode=mode, task=task, regw=cfg.regw, regv=cfg.regv,
              use_linear=cfg.use_linear, use_bias=cfg.use_bias, reg0=cfg.reg0)

    def run(P, w0, batches, E, lrs, min_t, max_t):
        """The batch loop on P and w0, in place: `batches` yields (ids,
        vals, y, row_mask, sids, order, max_run) on P's device, E = B*L
        entries a batch."""
        lr0, lr1, lr2 = (float(x) for x in lrs)
        dev, dt = P.device, P.dtype
        upd = torch.empty(E, P.shape[1], dtype=dt, device=dev)
        red = torch.empty(2, dtype=dt, device=dev)
        step_scratch = sgd_step_scratch(dev)
        scatter_scratch = ScatterScratch(E, P.shape[1], dev)
        for b_ids, b_vals, b_y, b_mask, b_sids, b_order, b_run in batches:
            sgd_step(P, b_ids, b_vals, b_y, b_mask, w0, lr1=lr1, lr2=lr2,
                     min_target=min_t, max_target=max_t, order=b_order,
                     lr0=lr0 if cfg.use_bias else None, upd=upd, red=red,
                     scratch=step_scratch, **kw)
            table_scatter(P, b_sids, None, upd, scratch=scatter_scratch, max_run=b_run)

    def epoch(params, ids, vals, y, row_mask, sids, perm, lrs, min_t, max_t,
              max_runs=None):
        if max_runs is None:
            max_runs = longest_runs(sids)
        runs = [int(r) for r in max_runs]
        P = _packed(params)
        w0 = params.w0.clone()
        nb, B, L = ids.shape
        order = torch.empty_like(perm).scatter_(
            1, perm.long(),
            torch.arange(B * L, dtype=perm.dtype, device=P.device).expand(nb, -1))
        run(P, w0, zip(ids.unbind(0), vals.unbind(0), y.unbind(0), row_mask.unbind(0),
                       sids.unbind(0), order.reshape(nb, B, L).unbind(0), runs),
            B * L, lrs, min_t, max_t)
        return FMParams(w0=w0, w=P[:, 0].contiguous(), v=P[:, 1:].contiguous())

    epoch.run = run
    return epoch


def _epoch_mode(train, L: int) -> str:
    """The epoch specialization for the batches of `train` (a Dataset or a
    StreamingDataset), L entries a row: "pair" for uniform 2-entry one-hot
    rows (the recommender shape), "onehot" for uniform-L one-hot rows,
    else "general"."""
    if is_stream(train):
        lo, hi, ones = train.row_lengths()
        if not train.num_rows:
            return "general"
    else:
        lengths = np.diff(train.indptr)
        if not lengths.size:
            return "general"
        lo, hi, ones = int(lengths.min()), int(lengths.max()), bool((train.vals == 1.0).all())
    if not (lo == hi == L and ones):
        return "general"
    return "pair" if L == 2 else "onehot"


def upload_batches(stream, batch_size: int, max_nnz: int, device):
    """The batches of `stream.iter_batches` (ids, vals, y, row_mask) on
    `device`, one on the host at a time."""
    for batch in stream.iter_batches(batch_size, max_nnz):
        yield tuple(torch.as_tensor(a, device=device) for a in batch)


def stream_batches(stream, batch_size: int, max_nnz: int, device):
    """The batches of `stream.iter_batches`, each with its scatter order,
    on `device`: (ids, vals, y, row_mask, sids, order, max_run), the
    tensors `make_epoch_fn`'s loop takes of a resident batch stack. One
    batch is on the host at a time."""
    for ids, vals, y, mask in stream.iter_batches(batch_size, max_nnz):
        sids, perm = sorted_scatter_order(ids[None])
        order = np.empty_like(perm)
        order[0, perm[0]] = np.arange(perm.shape[1], dtype=perm.dtype)
        run = int(longest_runs(sids)[0])
        yield (*(torch.as_tensor(a, device=device) for a in (
            ids, vals, y, mask, sids[0], order[0].reshape(ids.shape))), run)


def sorted_scatter_order(ids: np.ndarray):
    """Host-side, once per batch stack: per-batch stable argsort of the
    flattened scatter ids. Returns (sorted_ids [NB, E], perm [NB, E])."""
    nb = ids.shape[0]
    E = ids.shape[1] * ids.shape[2]
    flat = np.ascontiguousarray(ids).reshape(nb, E)
    perm = np.argsort(flat, axis=1, kind="stable").astype(np.int32)
    sids = np.take_along_axis(flat, perm, axis=1)
    return sids, perm


def make_eval_fn(cfg: FMConfig, task: int):
    """evaluate(params, ids, vals, y, row_mask, min_t, max_t) over a stack
    of batches: (RMSE, MAE) for regression, (accuracy, 0) for
    classification, as 0-dim tensors. The scores come from fm_refresh in
    test mode over all rows at once; torch does the clamp, error and
    masked sums. `evaluate.stream(params, batches, min_t, max_t)` does the
    same over streamed batches."""

    def evaluate(params, ids, vals, y, row_mask, min_t, max_t):
        L = ids.shape[-1]
        pred = fm_refresh(_packed(params), ids.reshape(-1, L), vals.reshape(-1, L),
                          params.w0, use_linear=cfg.use_linear,
                          use_bias=cfg.use_bias)
        return metrics(pred, y, row_mask, min_t, max_t)

    def evaluate_stream(params, batches, min_t, max_t):
        """evaluate over the batches of `upload_batches` (one fm_refresh
        launch a batch); the scores are gathered on the device and reduced
        at once, as evaluate reduces a resident stack's."""
        P = _packed(params)
        pred, ys, masks = [], [], []
        for ids, vals, y, row_mask in batches:
            pred.append(fm_refresh(P, ids, vals, params.w0, use_linear=cfg.use_linear,
                                   use_bias=cfg.use_bias))
            ys.append(y)
            masks.append(row_mask)
        return metrics(torch.cat(pred), torch.cat(ys), torch.cat(masks), min_t, max_t)

    def metrics(pred, y, row_mask, min_t, max_t):
        m = row_mask.reshape(-1).to(pred.dtype)
        yv = y.reshape(-1).to(pred.dtype)
        cnt = m.sum().clamp_min(1.0)
        if task == TASK_REGRESSION:
            err = (pred.clamp(min_t, max_t) - yv) * m
            return torch.sqrt((err * err).sum() / cnt), err.abs().sum() / cnt
        correct = ((pred >= 0) & (yv >= 0)) | ((pred < 0) & (yv < 0))
        return (correct.to(pred.dtype) * m).sum() / cnt, torch.zeros_like(cnt)

    evaluate.stream = evaluate_stream
    return evaluate


def warn_truncated(stream, max_nnz: int, it: int) -> None:
    """After the first epoch of `learn_stream`: warn with the counts of
    rows cut at max_nnz entries and of the entries dropped, if any."""
    if it == 0 and stream.truncated_rows:
        import warnings

        warnings.warn(f"learn_stream: max_nnz={max_nnz} truncated {stream.truncated_rows} "
                      f"rows ({stream.truncated_entries} entries dropped); pass "
                      "max_nnz=None for the lossless default", stacklevel=3)


class SGDLearner:
    """Mini-batch SGD training on one device (default CUDA;
    raises when CUDA is absent, `device="cpu"` runs the plain versions).

    With batch_size=1 this is the reference algorithm exactly; larger
    batches trade per-step fidelity for throughput (libFM prints "DON'T
    FORGET TO SHUFFLE" for the same reason, fm_learn_sgd_element.h:51; use
    Dataset.shuffled()). `learn` returns the history, one
    (train metric, test metric, epoch seconds) tuple per epoch."""

    def __init__(
        self,
        cfg: FMConfig,
        task: int = TASK_REGRESSION,
        num_iter: int = 100,
        learn_rate: float = 0.1,
        learn_rates: tuple | None = None,
        batch_size: int = 1024,
        seed: int = 1,
        rlog=None,
        verbose: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.task = task
        self.num_iter = num_iter
        self.lrs = tuple(learn_rates) if learn_rates else (learn_rate,) * 3
        self.batch_size = batch_size
        self.seed = seed
        self.rlog = rlog
        self.verbose = verbose
        self.params: FMParams | None = None
        self.min_target = 0.0
        self.max_target = 0.0
        self._eval = make_eval_fn(cfg, task)
        self.history = []
        if rlog is not None:
            self._register_log_fields()

    def _register_log_fields(self):
        """The rlog columns (JAX sgd.py:332-341)."""
        nan = float("nan")
        if self.task == TASK_REGRESSION:
            self.rlog.add_field("rmse", nan)
            self.rlog.add_field("mae", nan)
        else:
            self.rlog.add_field("accuracy", nan)
        for f in ("time_pred", "time_learn", "time_learn2", "time_learn4"):
            self.rlog.add_field(f, nan)
        self.rlog.add_field("rmse_train", nan)

    def init_params(self, params: FMParams | None = None):
        """The learner's own draw (w = 0, V ~ N(init_mean, init_stdev)
        from `seed`), or `params` (e.g. carried across with
        convert.params_from_jax) moved to the learner's device."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = init_fm(self.cfg, gen)
        else:
            params = FMParams(*(torch.as_tensor(x).to(self.device)
                                for x in (params.w0, params.w, params.v)))
        self.params = params
        return params

    def _check_supported(self, *datasets):
        if any(getattr(d, "relations", None) for d in datasets):
            # libFM fm_learn_sgd.h:61-63
            raise ValueError("relations are not supported with SGD")
        k = self.cfg.num_factors
        if k < 1 or (self.device.type == "cuda" and k > MAX_FACTORS_CUDA):
            raise NotImplementedError(
                f"k={k}: the SGD and SGDA kernels take 1 <= k <= {MAX_FACTORS_CUDA}; "
                f"other k {RANGE_OF_K}")

    def _arrays(self, b: BatchedCSR):
        dev = self.device
        return (
            torch.as_tensor(b.ids, device=dev),
            torch.as_tensor(b.vals, device=dev),
            torch.as_tensor(b.y, device=dev),
            torch.as_tensor(b.row_mask, device=dev),
        )

    def learn(self, train: Dataset, test: Dataset):
        self._check_supported(train, test)
        base.check_num_features(self.cfg, train, test)
        if self.params is None:
            self.init_params()
        self.min_target = train.min_target
        self.max_target = train.max_target
        dev = self.device

        tb = batch_dataset(train, self.batch_size)
        eb = batch_dataset(test, self.batch_size)
        epoch = make_epoch_fn(self.cfg, self.task, _epoch_mode(train, tb.ids.shape[2]))
        t_arrs = self._arrays(tb)
        e_arrs = self._arrays(eb)
        sids, perm = sorted_scatter_order(tb.ids)
        t_scatter = (torch.as_tensor(sids, device=dev), torch.as_tensor(perm, device=dev))
        max_runs = longest_runs(sids)
        min_t, max_t = float(self.min_target), float(self.max_target)

        history = []
        for it in range(self.num_iter):
            c0 = iter_clocks(dev)
            # a named range for torch.profiler traces (chip_smoke.py
            # --profile); it ends after the clock's synchronise, so it
            # covers the epoch's device work
            with torch.profiler.record_function(f"epoch {it}"):
                self.params = epoch(self.params, *t_arrs, *t_scatter, self.lrs,
                                    min_t, max_t, max_runs)
                c1 = iter_clocks(dev)
            dt = c1[2] - c0[2]
            m_train = self._eval(self.params, *t_arrs, min_t, max_t)
            m_test = self._eval(self.params, *e_arrs, min_t, max_t)
            if self.rlog is None:
                tr, te = torch.stack([m_train[0], m_test[0]]).tolist()
            else:
                tr, te, mae = torch.stack([m_train[0], m_test[0], m_test[1]]).tolist()
            history.append((tr, te, dt))
            if self.verbose:
                print(f"#Iter={it:3d}\tTrain={tr:.6g}\tTest={te:.6g}")
            if self.rlog is not None:
                c2 = iter_clocks(dev)
                if self.task == TASK_REGRESSION:
                    self.rlog.log("rmse", te)
                    self.rlog.log("mae", mae)
                else:
                    self.rlog.log("accuracy", te)
                self.rlog.log("rmse_train", tr)
                # libFM logs the user-CPU learn time and the evaluation's
                # (fm_learn_sgd_element.h:55-74); time_learn2 is its clock()
                # (process CPU) and time_learn4 the wall seconds, the time
                # that counts when the work runs on a device
                self.rlog.log("time_learn", c1[0] - c0[0])
                self.rlog.log("time_learn2", c1[1] - c0[1])
                self.rlog.log("time_learn4", dt)
                self.rlog.log("time_pred", c2[0] - c1[0])
                self.rlog.new_line()
        self.history = history
        return history

    def learn_stream(self, stream, test: Dataset, max_nnz: int | None = None):
        """Out-of-core SGD (JAX sgd.py `learn_stream`): each epoch is one
        pass over the StreamingDataset `stream` (libFM trains from its
        bounded cache of rows, fmatrix.h:165-281), one padded batch on the
        host at a time and uploaded before its two launches. max_nnz
        defaults to the longest row, so that each batch is the one
        `learn` takes (`batch_dataset(train, batch_size)`) and the epoch
        ends in its bits; a smaller max_nnz cuts longer rows, with a
        warning that counts them. As in JAX, each epoch reports the test
        metric only (the train one is NaN) and the history holds (NaN,
        test metric, epoch seconds)."""
        self._check_supported(stream, test)
        if max_nnz is None:
            max_nnz = max(stream.max_row_nnz(), 1)
        base.check_num_features(self.cfg, stream, test)
        if self.params is None:
            self.init_params()
        self.min_target = stream.min_target
        self.max_target = stream.max_target
        dev = self.device
        e_arrs = self._arrays(batch_dataset(test, self.batch_size))
        epoch = make_epoch_fn(self.cfg, self.task, _epoch_mode(stream, max_nnz))
        min_t, max_t = float(self.min_target), float(self.max_target)
        E = self.batch_size * max_nnz

        history = []
        for it in range(self.num_iter):
            c0 = iter_clocks(dev)
            with torch.profiler.record_function(f"epoch {it}"):
                P = _packed(self.params)
                w0 = self.params.w0.clone()
                epoch.run(P, w0, stream_batches(stream, self.batch_size, max_nnz, dev), E,
                          self.lrs, min_t, max_t)
                self.params = FMParams(w0=w0, w=P[:, 0].contiguous(), v=P[:, 1:].contiguous())
                c1 = iter_clocks(dev)
            dt = c1[2] - c0[2]
            warn_truncated(stream, max_nnz, it)
            m_test = self._eval(self.params, *e_arrs, min_t, max_t)
            te, mae = torch.stack(m_test).tolist()
            c2 = iter_clocks(dev)
            history.append((float("nan"), te, dt))
            if self.verbose:
                print(f"#Iter={it:3d}\tTest={te:.6g}")
            if self.rlog is not None:
                if self.task == TASK_REGRESSION:
                    self.rlog.log("rmse", te)
                    self.rlog.log("mae", mae)
                else:
                    self.rlog.log("accuracy", te)
                self.rlog.log("time_learn", c1[0] - c0[0])
                self.rlog.log("time_learn2", c1[1] - c0[1])
                self.rlog.log("time_learn4", dt)
                self.rlog.log("time_pred", c2[0] - c1[0])
                self.rlog.new_line()
        self.history = history
        return history

    def evaluate(self, ds: Dataset) -> float:
        self._check_supported(ds)
        b = batch_dataset(ds, self.batch_size)
        m = self._eval(self.params, *self._arrays(b), float(self.min_target),
                       float(self.max_target))
        return float(m[0])

    def predict(self, ds: Dataset) -> np.ndarray:
        """Linked predictions (clamped / sigmoid), libFM fm_learn_sgd.h:76-90."""
        self._check_supported(ds)
        b = batch_dataset(ds, self.batch_size)
        ids, vals = (torch.as_tensor(x.reshape(-1, b.max_nnz), device=self.device)
                     for x in (b.ids, b.vals))
        pred = fm_refresh(_packed(self.params), ids, vals, self.params.w0,
                          use_linear=self.cfg.use_linear, use_bias=self.cfg.use_bias)
        return base.link_prediction(
            pred[: ds.num_rows], self.task, self.min_target, self.max_target
        ).cpu().numpy()
