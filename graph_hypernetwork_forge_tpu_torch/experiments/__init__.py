"""The experiment scripts: the counterparts of the JAX package's
``experiments/*.py``, each runnable as
``python -m graph_hypernetwork_forge_tpu_torch.experiments.<name>``:

- ``train_linkpred``: link-prediction training with filtered MRR/Hits@K,
  on the whole test split and on the zero-shot relations;
- ``sweep_zeroshot``: the K-negatives × seeds sweep of zero-shot MRR, with
  best-on-valid selection (``sel_*``);
- ``parity_zeroshot``: the port trained with the JAX run's protocol, beside
  a JAX run's rows read from a file (``--against``).

``protocol`` holds what they share: the datasets, the learning rate, the
optimizer and the evaluation protocol.
"""
