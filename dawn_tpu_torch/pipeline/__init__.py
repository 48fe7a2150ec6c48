"""The inference pipeline: WAV + portrait in, video out (``generator``)."""
