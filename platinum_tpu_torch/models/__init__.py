"""Camera rays, Fresnel, GGX, the principled BSDF and light sampling."""
