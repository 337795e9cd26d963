"""The validation tools, counterpart of ``nirgan_tpu/validation`` (reference
``validation_utils/``): the per-sample metric sweep with its geographic
joins (``spider.py``), the radar comparisons (``spiders.py``), the offline
results table behind ``python -m nirgan_tpu_torch.validate``
(``results_table.py``) and the NDVI time series (``time_series.py``)."""
