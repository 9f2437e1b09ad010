"""One module per kind of measured window; a traffic mix names its driver,
and ``run(ctx)`` returns the run's record (see ``portbench/record.py``)."""
