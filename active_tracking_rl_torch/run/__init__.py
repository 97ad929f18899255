"""The port's command-line entry points: `train`, `eval`, `eval_matrix`,
`train_host`, `random_agent`, `demo`, `parity` and `profile_summary`."""
