"""The port's web UI: a stdlib HTTP sampling server (``app.py``)."""
