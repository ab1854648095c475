"""The post stack: option structs, the tonemappers and the pass pipeline."""
