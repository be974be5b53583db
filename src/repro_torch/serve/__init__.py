"""Serving: the LM's slot engine (``engine``) and the compressed-tensor
``CodecService`` (``codec_service``)."""
