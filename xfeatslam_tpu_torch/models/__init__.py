"""XFeat network, weight IO and the extractor facade."""
