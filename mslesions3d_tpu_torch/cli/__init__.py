"""Command-line entry points, each run as ``python -m mslesions3d_tpu_torch.cli.<name>``:

- ``train``: train from a dataset on disk (``Trainer.fit``);
- ``predict``: a checkpoint's detections per subject, and per-subject metrics;
- ``eval``: the metric files of a prediction run at a score and IoU threshold;
- ``export``: a checkpoint as a ``.mslx`` serving bundle (``torch.export``
  programs, optionally int8 or the whole sliding window);
- ``serve``: a bundle's detections for NIfTI volumes, or an HTTP server;
- ``import_torch``: a reference PyTorch checkpoint as a port checkpoint;
- ``tune_lr``: the learning-rate sweep;
- ``model_insight``: prior-box wireframes and parameter histograms;
- ``stats_objects``: ground-truth box statistics of a dataset;
- ``plots``: heatmaps and boxplots of ``eval``'s metric files.

``recipe`` is no entry point: it holds the JAX package's 4k recipe (dataset,
training and scoring flags, eval grid) that the trained check and the
chip smoke run.

``model_insight histograms``, ``stats_objects`` and ``plots`` draw with
matplotlib (``plots`` also with seaborn, pandas and scipy); each imports
them when it draws and raises an ImportError naming a missing one.
"""
