"""Traffic generators: `perfbench/traffic/<traffic>.json` names one by its
`generator` key, and the module of that name here reads the rest of the
file."""
