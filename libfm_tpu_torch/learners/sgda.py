"""SGDA: SGD with self-adaptive per-group regularization (PyTorch, one
device).

The port of `libfm_tpu.learners.sgda` (libFM
fm_learn_sgd_element_adapt_reg.h:43-360, WSDM 2012): parameter (theta)
steps on training mini-batches alternate with regularization (lambda)
steps on validation mini-batches, taken round-robin, with no lambda step
in the first epoch (:303). Each feature's group (`attr_group`) owns a
regularizer reg_w[g] of w and reg_v[g, :] of V, both starting at 0,
learned on the validation rows and clamped at 0.

An epoch works on the packed table P = [w | V] [n, 1+k] and the gradient
caches Gc = [grad_w | grad_v] [n+1, 1+k] (row n a dummy row that no
step writes or reads). Per training batch i:
  sgda_step      (CUDA kernel: gather, prediction, SGDA multiplier, update
                  rows in the presorted order, cache rows, w0 in place),
  table_scatter  (CUDA kernel: the rows added in the presorted order),
  sgda_lambda    (CUDA kernel, from the second epoch: the look-ahead on
                  validation batch i % (validation batches), the per-group
                  sums and the clamped step on reg_w and reg_v in place).
The batch loop issues those launches and nothing else; the regularizers
stay on the device. Evaluation uses fm_refresh in test mode. On CPU
tensors every kernel wrapper runs its plain PyTorch version.

One learn rate, the first of `learn_rates`, drives every layer (JAX
sgda.py:205). With an `rlog` each epoch writes one row of the JAX
learner's fields, `rmse_val` among them. `learn_stream` trains out of
core from a `data.streaming.StreamingDataset`, with a resident or a
streamed validation set: the batches of `learn`, one on the host at a
time, through the same launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from libfm_tpu_torch.data.batching import BatchedCSR, batch_dataset
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.streaming import is_stream
from libfm_tpu_torch.kernels.sgda_lambda import sgda_lambda, sgda_lambda_scratch
from libfm_tpu_torch.kernels.sgda_step import sgda_step, sgda_step_scratch
from libfm_tpu_torch.kernels.table_scatter import ScatterScratch, longest_runs, table_scatter
from libfm_tpu_torch.learners import base
from libfm_tpu_torch.learners.sgd import (
    SGDLearner, _epoch_mode, _packed, sorted_scatter_order, upload_batches, warn_truncated,
)
from libfm_tpu_torch.models.fm import FMConfig, FMParams
from libfm_tpu_torch.tasks import TASK_REGRESSION
from libfm_tpu_torch.utils.timers import iter_clocks

__all__ = ["SGDALearner", "SGDABatches", "make_epoch_fn", "sgda_batches",
           "sgda_scatter_plan"]


def sgda_scatter_plan(ids: np.ndarray, vals: np.ndarray, n: int):
    """Host-side, once per batch stack ids, vals [NB, B, L]: the scatter
    order and the gradient caches' writers. The entries of value 0 (the
    padded slots) are keyed to n, as JAX's theta_step keys its cache
    writes (sgda.py:79-81). Returns

    - sids [NB, E] (E = B*L): the keys in sorted order (stable);
    - order [NB, B, L] int32: each entry's sorted position;
    - gc_row [NB, B, L] int32: the cache row the entry writes, its id for
      the last entry in entry order of each id's run of value != 0 (the
      write `.at[sids].set` keeps on XLA's CPU backend), n (no write) for
      every other entry;
    - n_real [NB]: the positions keyed below n, a prefix of the sorted
      order: the update rows that table_scatter adds (the others are
      zeros)."""
    nb, B, L = ids.shape
    E = B * L
    keys = np.where(vals != 0, ids, n).astype(np.int32)
    sids, perm = sorted_scatter_order(keys)
    last = np.ones((nb, E), bool)
    last[:, :-1] = sids[:, 1:] != sids[:, :-1]
    writer = np.where(last & (sids < n), sids, n).astype(np.int32)
    rows = np.arange(nb)[:, None]
    gc_row = np.empty((nb, E), np.int32)
    gc_row[rows, perm] = writer
    order = np.empty((nb, E), np.int32)
    order[rows, perm] = np.arange(E, dtype=np.int32)
    n_real = (sids < n).sum(axis=1)
    return sids, order.reshape(nb, B, L), gc_row.reshape(nb, B, L), n_real


@dataclass
class SGDABatches:
    """A training batch stack on the device with its static scatter plan
    (`sgda_scatter_plan`), made once at set-up."""

    ids: torch.Tensor  # int32 [NB, B, L]
    vals: torch.Tensor  # float32 [NB, B, L]
    y: torch.Tensor  # float32 [NB, B]
    row_mask: torch.Tensor  # bool [NB, B]
    sids: torch.Tensor  # int32 [NB, B*L]
    order: torch.Tensor  # int32 [NB, B, L]
    gc_row: torch.Tensor  # int32 [NB, B, L]
    n_real: list  # int a batch
    max_runs: list  # int a batch: the longest run of equal ids in sids[:n_real]

    @property
    def arrays(self):
        return self.ids, self.vals, self.y, self.row_mask


def sgda_batches(tb: BatchedCSR, n: int, device) -> SGDABatches:
    """The device stack of `tb` with its scatter plan for n features."""
    sids, order, gc_row, n_real = sgda_scatter_plan(tb.ids, tb.vals, n)
    runs = [int(longest_runs(s[:m])) if m else 0 for s, m in zip(sids, n_real)]
    return SGDABatches(*(torch.as_tensor(a, device=device) for a in (
        tb.ids, tb.vals, tb.y, tb.row_mask, sids, order, gc_row)),
        n_real=[int(m) for m in n_real], max_runs=runs)


def make_epoch_fn(cfg: FMConfig, task: int, mode: str = "general",
                  val_mode: str = "general"):
    """An SGDA epoch function, in place on the packed state.

    epoch(P, w0, Gc, reg_w, reg_v, attr_group, train, val, lr, min_t,
    max_t, do_lambda) runs one sgda_step + table_scatter per batch of
    `train` (an `SGDABatches`) and, with `do_lambda`, one sgda_lambda on
    validation batch i % NV of `val` ((ids, vals, y, row_mask) stacks)
    after batch i. It updates P [n, 1+k], w0 (0-dim), Gc [n+1, 1+k],
    reg_w [G] and reg_v [G, k] in place.

    Once an epoch it allocates the buffers and scratch and cuts the
    batches' views; a batch then costs its wrapper calls and nothing
    else. `mode` and `val_mode` ("pair", "onehot", "general") are
    `_epoch_mode`'s choice for each static batch stack."""
    kw = dict(task=task, use_linear=cfg.use_linear, use_bias=cfg.use_bias)

    def run(P, w0, Gc, reg_w, reg_v, attr_group, batches, val_batch, E, lr, min_t, max_t,
            do_lambda):
        """The batch loop, in place: `batches` yields (ids, vals, y,
        row_mask, order, gc_row, sids[:n_real], n_real, max_run) on P's
        device, E = B*L entries a batch; `val_batch(i)` gives the
        validation batch (ids, vals, y, row_mask) of the lambda step after
        batch i."""
        d, dev, dt = P.shape[1], P.device, P.dtype
        upd = torch.empty(E, d, dtype=dt, device=dev)
        red = torch.empty(1, dtype=dt, device=dev)
        step_scratch = sgda_step_scratch(dev)
        scatter_scratch = ScatterScratch(E, d, dev)
        lam_scratch = sgda_lambda_scratch(reg_w.shape[0], d - 1, dev)
        lims = dict(lr=lr, min_target=min_t, max_target=max_t, **kw)
        for i, (ids, vals, y, m, order, gc_row, sids, n_real, run) in enumerate(batches):
            sgda_step(P, ids, vals, y, m, w0, Gc, gc_row, attr_group, reg_w, reg_v,
                      mode=mode, order=order, upd=upd, red=red, scratch=step_scratch, **lims)
            table_scatter(P, sids, None, upd[:n_real], scratch=scatter_scratch, max_run=run)
            if do_lambda:
                sgda_lambda(P, Gc, *val_batch(i), w0, attr_group, reg_w, reg_v,
                            mode=val_mode, scratch=lam_scratch, **lims)

    def epoch(P, w0, Gc, reg_w, reg_v, attr_group, train: SGDABatches, val, lr, min_t,
              max_t, do_lambda=True):
        nb, B, L = train.ids.shape
        batches = zip(*(a.unbind(0) for a in (*train.arrays, train.order, train.gc_row)),
                      (s[:m] for s, m in zip(train.sids.unbind(0), train.n_real)),
                      train.n_real, train.max_runs)
        vbatches = list(zip(*(a.unbind(0) for a in val)))
        run(P, w0, Gc, reg_w, reg_v, attr_group, batches,
            lambda i: vbatches[i % len(vbatches)], B * L, lr, min_t, max_t, do_lambda)

    epoch.run = run
    return epoch


def stream_sgda_batches(stream, batch_size: int, max_nnz: int, n: int, device):
    """The batches of `stream.iter_batches`, each with its scatter plan
    (`sgda_scatter_plan`) for n features, on `device`: the tuples
    `make_epoch_fn`'s loop takes of a resident stack. One batch is on the
    host at a time."""
    for ids, vals, y, mask in stream.iter_batches(batch_size, max_nnz):
        sids, order, gc_row, n_real = sgda_scatter_plan(ids[None], vals[None], n)
        m = int(n_real[0])
        run = int(longest_runs(sids[0, :m])) if m else 0
        yield (*(torch.as_tensor(a, device=device) for a in (
            ids, vals, y, mask, order[0], gc_row[0], sids[0, :m])), m, run)


class SGDALearner(SGDLearner):
    """SGDA training on one device (default CUDA; raises when CUDA is
    absent, `device="cpu"` runs the plain versions). `attr_group` [n]
    gives each feature's group (all in group 0 when None). `learn(train,
    test, validation)` returns the history, one (train metric, test
    metric, validation metric, epoch seconds) tuple per epoch, and leaves
    the learned regularizers in `reg_w` [G] and `reg_v` [G, k]."""

    def __init__(self, cfg: FMConfig, attr_group=None, **kwargs):
        super().__init__(cfg, **kwargs)
        n = cfg.num_features
        groups = (np.zeros(n, np.int32) if attr_group is None
                  else np.asarray(attr_group, dtype=np.int32))
        if groups.shape != (n,) or (n and groups.min() < 0):
            raise ValueError(f"attr_group: one group id >= 0 for each of the {n} "
                             f"features, got shape {groups.shape}")
        self.attr_group_np = groups
        self.num_groups = int(groups.max()) + 1 if n else 1
        self.reg_w = None
        self.reg_v = None

    def _register_log_fields(self):
        super()._register_log_fields()
        self.rlog.add_field("rmse_val", float("nan"))

    def learn(self, train: Dataset, test: Dataset, validation: Dataset = None):
        self._check_supported(train, test, validation)
        if validation is None:
            raise ValueError("SGDA requires a validation set")
        base.check_num_features(self.cfg, train, test, validation)
        if self.params is None:
            self.init_params()
        # the reference resets w and the regularizers at learn()
        # (adapt_reg.h:281-289)
        p = self.params
        self.params = FMParams(p.w0, torch.zeros_like(p.w), p.v)
        self.min_target = train.min_target
        self.max_target = train.max_target
        cfg, dev = self.cfg, self.device
        n, k, G = cfg.num_features, cfg.num_factors, self.num_groups
        dt = self.params.v.dtype

        tb = batch_dataset(train, self.batch_size)
        vb = batch_dataset(validation, self.batch_size)
        eb = batch_dataset(test, self.batch_size)
        epoch = make_epoch_fn(cfg, self.task, _epoch_mode(train, tb.ids.shape[2]),
                              _epoch_mode(validation, vb.ids.shape[2]))
        t_batches = sgda_batches(tb, n, dev)
        v_arrs, e_arrs = self._arrays(vb), self._arrays(eb)
        attr_group = torch.as_tensor(self.attr_group_np, device=dev)
        P = _packed(self.params)
        w0 = self.params.w0.clone()
        # one dummy row (n) that no step writes or reads: the padded slots
        # write no cache row (sgda.py:211-216)
        Gc = torch.zeros(n + 1, k + 1, dtype=dt, device=dev)
        reg_w = torch.zeros(G, dtype=dt, device=dev)
        reg_v = torch.zeros(G, k, dtype=dt, device=dev)
        lr = float(self.lrs[0])
        min_t, max_t = float(self.min_target), float(self.max_target)

        history = []
        for it in range(self.num_iter):
            c0 = iter_clocks(dev)
            with torch.profiler.record_function(f"epoch {it}"):
                epoch(P, w0, Gc, reg_w, reg_v, attr_group, t_batches, v_arrs, lr, min_t,
                      max_t, do_lambda=it > 0)
                c1 = iter_clocks(dev)
            dt_s = c1[2] - c0[2]
            self.params = FMParams(w0, P[:, 0], P[:, 1:])
            m_val = self._eval(self.params, *v_arrs, min_t, max_t)
            m_train = self._eval(self.params, *t_batches.arrays, min_t, max_t)
            m_test = self._eval(self.params, *e_arrs, min_t, max_t)
            tr, te, vl = torch.stack([m_train[0], m_test[0], m_val[0]]).tolist()
            history.append((tr, te, vl, dt_s))
            if self.verbose:
                print(f"#Iter={it:3d}\tTrain={tr:.6g}\tTest={te:.6g}")
            if self.rlog is not None:
                c2 = iter_clocks(dev)
                self.rlog.log("rmse" if self.task == TASK_REGRESSION else "accuracy", te)
                self.rlog.log("rmse_train", tr)
                self.rlog.log("rmse_val", vl)
                self.rlog.log("time_learn", c1[0] - c0[0])
                self.rlog.log("time_learn4", dt_s)
                self.rlog.log("time_pred", c2[0] - c1[0])
                self.rlog.new_line()
        self.params = FMParams(w0, P[:, 0].contiguous(), P[:, 1:].contiguous())
        self.reg_w, self.reg_v = reg_w, reg_v
        self.history = history
        return history

    def learn_stream(self, stream, test: Dataset, validation=None,
                     max_nnz: int | None = None):
        """Out-of-core SGDA (JAX sgda.py `learn_stream`): the train set
        streams from the StreamingDataset `stream`, one batch on the host at
        a time, through the launches of `learn`. `validation` is a resident
        Dataset or a StreamingDataset; the lambda step after batch i takes
        validation batch i % (its batches) from the epoch's start
        (adapt_reg.h:294-311), so a streamed validation set is read in
        order through one bounded window, from its start again at each
        epoch. max_nnz defaults to the longest train row: each batch is
        then `learn`'s and the run ends in its bits. The history holds
        (NaN, test metric, validation metric, epoch seconds), the
        validation metric over all its rows (summed, not a mean of batch
        metrics)."""
        self._check_supported(stream, test, validation)
        if validation is None:
            raise ValueError("SGDA requires a validation set")
        if max_nnz is None:
            max_nnz = max(stream.max_row_nnz(), 1)
        base.check_num_features(self.cfg, stream, test, validation)
        if self.params is None:
            self.init_params()
        p = self.params  # w and the regularizers start at 0 (adapt_reg.h:281-289)
        self.params = FMParams(p.w0, torch.zeros_like(p.w), p.v)
        self.min_target = stream.min_target
        self.max_target = stream.max_target
        cfg, dev, B = self.cfg, self.device, self.batch_size
        n, k, G = cfg.num_features, cfg.num_factors, self.num_groups
        dt = self.params.v.dtype

        val_stream = is_stream(validation)
        if val_stream:
            v_nnz = max(validation.max_row_nnz(), 1)
            val_mode = _epoch_mode(validation, v_nnz)

            def val_batches():
                """The validation batches in order, round and round."""
                while True:
                    empty = True
                    for vb in upload_batches(validation, B, v_nnz, dev):
                        empty = False
                        yield vb
                    if empty:
                        raise ValueError("the validation stream holds no row")
        else:
            vb = batch_dataset(validation, B)
            v_arrs = self._arrays(vb)
            val_mode = _epoch_mode(validation, vb.ids.shape[2])
            vbatches = list(zip(*(a.unbind(0) for a in v_arrs)))
        e_arrs = self._arrays(batch_dataset(test, B))
        epoch = make_epoch_fn(cfg, self.task, _epoch_mode(stream, max_nnz), val_mode)
        attr_group = torch.as_tensor(self.attr_group_np, device=dev)
        P = _packed(self.params)
        w0 = self.params.w0.clone()
        Gc = torch.zeros(n + 1, k + 1, dtype=dt, device=dev)
        reg_w = torch.zeros(G, dtype=dt, device=dev)
        reg_v = torch.zeros(G, k, dtype=dt, device=dev)
        lr = float(self.lrs[0])
        min_t, max_t = float(self.min_target), float(self.max_target)

        history = []
        for it in range(self.num_iter):
            c0 = iter_clocks(dev)
            if val_stream:
                vit = val_batches()  # from the start at each epoch (adapt_reg.h:299)

                def val_batch(i):
                    return next(vit)
            else:
                def val_batch(i):
                    return vbatches[i % len(vbatches)]
            with torch.profiler.record_function(f"epoch {it}"):
                epoch.run(P, w0, Gc, reg_w, reg_v, attr_group,
                          stream_sgda_batches(stream, B, max_nnz, n, dev), val_batch,
                          B * max_nnz, lr, min_t, max_t, it > 0)
                c1 = iter_clocks(dev)
            dt_s = c1[2] - c0[2]
            warn_truncated(stream, max_nnz, it)
            self.params = FMParams(w0, P[:, 0], P[:, 1:])
            m_val = (self._eval.stream(self.params, upload_batches(validation, B, v_nnz, dev),
                                       min_t, max_t)
                     if val_stream else self._eval(self.params, *v_arrs, min_t, max_t))
            m_test = self._eval(self.params, *e_arrs, min_t, max_t)
            te, vl = torch.stack([m_test[0], m_val[0]]).tolist()
            history.append((float("nan"), te, vl, dt_s))
            if self.verbose:
                print(f"#Iter={it:3d}\tTest={te:.6g}")
            if self.rlog is not None:
                c2 = iter_clocks(dev)
                self.rlog.log("rmse" if self.task == TASK_REGRESSION else "accuracy", te)
                self.rlog.log("rmse_val", vl)
                self.rlog.log("time_learn", c1[0] - c0[0])
                self.rlog.log("time_learn4", dt_s)
                self.rlog.log("time_pred", c2[0] - c1[0])
                self.rlog.new_line()
        self.params = FMParams(w0, P[:, 0].contiguous(), P[:, 1:].contiguous())
        self.reg_w, self.reg_v = reg_w, reg_v
        self.history = history
        return history
