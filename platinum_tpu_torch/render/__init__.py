"""Scene types, the flattener, the wavefront integrator and the Renderer."""
