"""Network modules: PointNet encoder, delta heads, CATRE trunk, composition."""
