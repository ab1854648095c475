"""post.display_ms: the host span around `Renderer.output_image()` (the
post stack and the copy of the display image to the host), started after
the frame's render step has finished on the device: the mean over the
frames of the traced window."""


def read(rec):
    spans = rec.get("post_spans")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
