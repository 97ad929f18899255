"""The port's command-line entry points: `train`, `eval` and `eval_matrix`."""
