"""The test pass with its samples (port of ``train/predict.py``'s
``PredictMixin``, the streaming path), mixed into ``train.Trainer``."""

import numpy as np
import torch

from hydragnn_tpu_torch.train.common import TrainState, _env_flag


class PredictMixin:
    def predict(self, state: TrainState, loader):
        """The test pass with its samples: ``(mean loss, per-task
        mean losses, true values, predicted values)``, the values per head
        as ``[rows, 1]`` arrays over the real graphs (graph heads) or
        nodes (node heads), in loader order; an NLL head's prediction is
        its mean channels only."""
        if _env_flag("HYDRAGNN_PREDICT_DEVICE_RESIDENT", self.training_config,
                     "predict_device_resident",
                     default=_env_flag("HYDRAGNN_DEVICE_RESIDENT", self.training_config,
                                       "device_resident_dataset")):
            raise NotImplementedError(
                "the device-resident predict path is not ported yet: see ROADMAP.md, "
                "queue 1, item 5")
        heads = range(self.model.num_heads)
        acc, host, outputs = None, [], [[] for _ in heads]
        for batch in self._batches(loader):
            metrics = self.eval_step(state, batch)
            acc = self._acc_add(acc, metrics)
            host.append(batch)
            for ihead in heads:
                outputs[ihead].append(metrics["outputs"][ihead])
        loss, tasks = self._acc_read(acc)
        outputs = [torch.cat(o).float().cpu().numpy() for o in outputs]
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
        return loss, np.atleast_1d(tasks), true_values, predicted_values
