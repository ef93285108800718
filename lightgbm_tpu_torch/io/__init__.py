"""Model text IO in the reference's format (``model_text.py``) and the
model as C++ source (``codegen.py``, ``task=convert_model``)."""
