"""Multi-device paths: the view-sharded CVA-MVSNet forward
(``view_shard``), the accounting of its sums (``collectives``) and the
multi-process dry runs (``dryrun``). Data-parallel training is
``train/trainer.py``'s."""


def __getattr__(name):
    # Exported lazily: models/layers.py imports ``collectives`` from this
    # package, and view_shard imports the models.
    if name == "build_view_sharded_forward":
        from .view_shard import build_view_sharded_forward
        return build_view_sharded_forward
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
