"""Model text IO in the reference's format (``model_text.py``)."""
