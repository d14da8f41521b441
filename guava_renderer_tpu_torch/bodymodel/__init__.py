"""Body model: numpy assets (data, teeth, synthetic rig) and the EHM forward."""
