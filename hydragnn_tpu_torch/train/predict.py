"""The test pass with its samples (port of ``train/predict.py``'s
``PredictMixin``), mixed into ``train.Trainer``.

With ``predict_device_resident`` (config or
``HYDRAGNN_PREDICT_DEVICE_RESIDENT``; default: ``device_resident_dataset``
/ ``HYDRAGNN_DEVICE_RESIDENT``) the test set is stacked, staged on the
device and run by ``predict_scan``, one replay a microbatch, and read back
once. The JAX package's two documented fallbacks to the streaming pass are
kept: batches of more than one shape (``stack_batches`` raises
``ValueError``), and a stage over its budget (``MemoryError``: the stack's
bytes and the outputs' over ``HYDRAGNN_PREDICT_STAGE_BUDGET``, else
``Training.predict_stage_budget_bytes``, else 8 GiB); memory exhausted on
the device while staging falls back too.

``HYDRAGNN_DUMP_TESTDATA`` writes the pass's per-head true and predicted
rows as the JAX package does (``true_<i>``, ``pred_<i>`` in one ``.npz``):
``1`` names the file ``testdata_rank0.npz``, any other value is the path.
The port runs one process, rank 0 (``parallel/`` is not ported).
"""

import os

import numpy as np
import torch

from hydragnn_tpu_torch.graph.batch import stack_batches
from hydragnn_tpu_torch.train.common import TrainState, _env_flag, _is_oom, _nbatch


class PredictMixin:
    _PREDICT_STAGE_BUDGET_BYTES = 8 * 1024**3

    def _predict_stage_budget(self) -> int:
        """The stage's budget in bytes: ``HYDRAGNN_PREDICT_STAGE_BUDGET``
        (scientific notation accepted) > ``predict_stage_budget_bytes`` >
        8 GiB."""
        env = os.getenv("HYDRAGNN_PREDICT_STAGE_BUDGET")
        if env is not None:
            try:
                return int(float(env))
            except ValueError:
                raise ValueError(
                    f"HYDRAGNN_PREDICT_STAGE_BUDGET must be a byte count, got {env!r}") from None
        cfg = self.training_config.get("predict_stage_budget_bytes")
        return self._PREDICT_STAGE_BUDGET_BYTES if cfg is None else int(cfg)

    def _stack_for_predict(self, host_batches, budget):
        """The stacked test set; raises ``ValueError`` (ragged) or
        ``MemoryError`` (over ``budget``)."""
        stacked = stack_batches(host_batches)
        stage_bytes = sum(t.numel() * t.element_size() for t in stacked.leaves()[1])
        nb = len(host_batches)
        rows = {"graph": host_batches[0].graph_mask.shape[0],
                "node": host_batches[0].node_mask.shape[0]}
        out_bytes = sum(nb * rows[t] * d * 4
                        for t, d in zip(self.model.output_type, self.model.output_dim))
        if stage_bytes + out_bytes > budget:
            raise MemoryError(
                f"staged predict would need {stage_bytes + out_bytes} bytes (budget {budget})")
        return stacked

    def predict(self, state: TrainState, loader):
        """The test pass with its samples: ``(mean loss, per-task
        mean losses, true values, predicted values)``, the values per head
        as ``[rows, 1]`` arrays over the real graphs (graph heads) or
        nodes (node heads), in loader order; an NLL head's prediction is
        its mean channels only."""
        device_resident = _env_flag(
            "HYDRAGNN_PREDICT_DEVICE_RESIDENT", self.training_config, "predict_device_resident",
            default=_env_flag("HYDRAGNN_DEVICE_RESIDENT", self.training_config,
                              "device_resident_dataset"))
        if device_resident:
            budget = self._predict_stage_budget()  # a bad budget raises, not falls back
            host = list(self._batches(loader, _nbatch(loader)))
            try:
                stacked = self._stack_for_predict(host, budget)
            except (ValueError, MemoryError):
                loader = host
            else:
                try:
                    return self._predict_device_resident(state, host, stacked)
                except Exception as e:
                    if not _is_oom(e):
                        raise
                    loader = host
                finally:
                    del stacked
        heads = range(self.model.num_heads)
        acc, host, outputs = None, [], [[] for _ in heads]
        batches = loader if isinstance(loader, list) else self._batches(loader, _nbatch(loader))
        for batch in batches:
            metrics = self.eval_step(state, batch)
            acc = self._acc_add(acc, metrics)
            host.append(batch)
            for ihead in heads:
                outputs[ihead].append(metrics["outputs"][ihead])
        loss, tasks = self._acc_read(acc)
        outputs = [torch.cat(o).float().cpu().numpy() for o in outputs]
        return self._collect(loss, tasks, host, outputs)

    def _predict_device_resident(self, state: TrainState, host_batches, stacked):
        """``predict_scan`` over the staged test set, and one readback."""
        from hydragnn_tpu_torch.train.steps import Staged

        staged = Staged(self.put_batch(stacked), self.model.num_heads)
        outs = self.programs(state).eval_epoch(staged, staged.nb, outputs=True)
        flat = torch.cat([staged.rows.reshape(-1)] + [o.reshape(-1) for o in outs]).cpu().numpy()
        loss, tasks = self._rows_mean(torch.from_numpy(flat[: staged.rows.numel()]).view(
            staged.rows.shape))
        outputs, off = [], staged.rows.numel()
        for o in outs:  # per head [nb, rows, dim] -> the streaming pass's [nb * rows, dim]
            n = o.numel()
            outputs.append(flat[off : off + n].reshape(-1, o.shape[-1]))
            off += n
        return self._collect(loss, tasks, host_batches, outputs)

    def _collect(self, loss, tasks, host, outputs):
        """The per-head true and predicted rows of ``host``'s real graphs
        or nodes, from ``outputs`` (per head, the batches' rows
        concatenated)."""
        heads = range(self.model.num_heads)
        true_values, predicted_values = [[] for _ in heads], [[] for _ in heads]
        for ihead in heads:
            row = 0
            for batch in host:
                graph = self.model.output_type[ihead] == "graph"
                mask = (batch.graph_mask if graph else batch.node_mask).numpy()
                true = batch.targets[ihead].numpy()[mask]
                pred = outputs[ihead][row : row + mask.shape[0]][mask][..., : true.shape[-1]]
                row += mask.shape[0]
                true_values[ihead].append(true.reshape(-1, 1))
                predicted_values[ihead].append(pred.reshape(-1, 1))
        true_values = [np.concatenate(v, axis=0) for v in true_values]
        predicted_values = [np.concatenate(v, axis=0) for v in predicted_values]
        dump = os.getenv("HYDRAGNN_DUMP_TESTDATA")
        if dump:
            np.savez("testdata_rank0.npz" if dump == "1" else dump,
                     **{f"true_{i}": v for i, v in enumerate(true_values)},
                     **{f"pred_{i}": v for i, v in enumerate(predicted_values)})
        return loss, np.atleast_1d(tasks), true_values, predicted_values
