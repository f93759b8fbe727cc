"""The long-run tools of the port, each run as
``python -m gan_sr_wind_field_tpu_torch.scripts.<name>``: the counterparts
of the root ``scripts/supervise_train.py`` (relaunch a training run from
its newest checkpoint), ``scripts/export_continuation.py`` (a run's
checkpoint into a continuation pack) and ``scripts/summarize_longrun.py``
(a run's summary and band plot)."""
