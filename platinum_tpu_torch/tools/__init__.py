"""Host tools: the foreign-layout glTF writer."""
