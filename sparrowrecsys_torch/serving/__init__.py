"""Online serving plane: catalog, recall and rank pipelines, HTTP facade."""
