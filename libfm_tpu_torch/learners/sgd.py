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
one row of the JAX learner's fields. Streaming data (`learn_stream`)
waits for ROADMAP §1 item 4 ("Streaming data") and raises
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from libfm_tpu_torch.data.batching import BatchedCSR, batch_dataset
from libfm_tpu_torch.data.dataset import Dataset
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
_NOT_YET = 'waits for ROADMAP §1 item 4 ("Streaming data")'


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

    def epoch(params, ids, vals, y, row_mask, sids, perm, lrs, min_t, max_t,
              max_runs=None):
        lr0, lr1, lr2 = (float(x) for x in lrs)
        if max_runs is None:
            max_runs = longest_runs(sids)
        runs = [int(r) for r in max_runs]
        P = _packed(params)
        w0 = params.w0.clone()
        nb, B, L = ids.shape
        dev, dt = P.device, P.dtype
        order = torch.empty_like(perm).scatter_(
            1, perm.long(), torch.arange(B * L, dtype=perm.dtype, device=dev).expand(nb, -1))
        upd = torch.empty(B * L, P.shape[1], dtype=dt, device=dev)
        red = torch.empty(2, dtype=dt, device=dev)
        step_scratch = sgd_step_scratch(dev)
        scatter_scratch = ScatterScratch(B * L, P.shape[1], dev)
        batches = list(zip(ids.unbind(0), vals.unbind(0), y.unbind(0),
                           row_mask.unbind(0), sids.unbind(0),
                           order.reshape(nb, B, L).unbind(0), runs))
        for b_ids, b_vals, b_y, b_mask, b_sids, b_order, b_run in batches:
            sgd_step(P, b_ids, b_vals, b_y, b_mask, w0, lr1=lr1, lr2=lr2,
                     min_target=min_t, max_target=max_t, order=b_order,
                     lr0=lr0 if cfg.use_bias else None, upd=upd, red=red,
                     scratch=step_scratch, **kw)
            table_scatter(P, b_sids, None, upd, scratch=scatter_scratch, max_run=b_run)
        return FMParams(w0=w0, w=P[:, 0].contiguous(), v=P[:, 1:].contiguous())

    return epoch


def _epoch_mode(train: Dataset, tb: BatchedCSR) -> str:
    """The epoch specialization for the static batch stack: "pair" for
    uniform 2-entry one-hot rows (the recommender shape), "onehot" for
    uniform-L one-hot rows, else "general"."""
    lengths = np.diff(train.indptr)
    L = tb.ids.shape[2]
    uniform = lengths.size > 0 and int(lengths.min()) == int(lengths.max()) == L
    if not uniform:
        return "general"
    if not (train.vals == 1.0).all():
        return "general"
    return "pair" if L == 2 else "onehot"


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
    masked sums."""

    def evaluate(params, ids, vals, y, row_mask, min_t, max_t):
        L = ids.shape[-1]
        pred = fm_refresh(_packed(params), ids.reshape(-1, L), vals.reshape(-1, L),
                          params.w0, use_linear=cfg.use_linear,
                          use_bias=cfg.use_bias)
        m = row_mask.reshape(-1).to(pred.dtype)
        yv = y.reshape(-1).to(pred.dtype)
        cnt = m.sum().clamp_min(1.0)
        if task == TASK_REGRESSION:
            err = (pred.clamp(min_t, max_t) - yv) * m
            return torch.sqrt((err * err).sum() / cnt), err.abs().sum() / cnt
        correct = ((pred >= 0) & (yv >= 0)) | ((pred < 0) & (yv < 0))
        return (correct.to(pred.dtype) * m).sum() / cnt, torch.zeros_like(cnt)

    return evaluate


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
        epoch = make_epoch_fn(self.cfg, self.task, _epoch_mode(train, tb))
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
        """Out-of-core SGD over a StreamingDataset."""
        raise NotImplementedError(f"learn_stream {_NOT_YET}")

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
