"""Training loops of the port: the video-model train step."""
