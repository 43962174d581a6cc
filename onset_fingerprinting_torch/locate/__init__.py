"""Localization: lag maps, TDOA trilateration and the online locators
(port of ``onset_fingerprinting_tpu.locate``)."""

from onset_fingerprinting_torch.locate.geometry import (
    attenuate_intensity,
    lag_intensity_map,
    lag_map_2d,
    lag_map_3d,
)
from onset_fingerprinting_torch.locate.trilateration import (
    solve_trilateration,
    solve_trilateration_3d,
    trilaterate_batch,
)
from onset_fingerprinting_torch.locate.multilaterate import (
    LocatorConfig,
    LocatorState,
    Multilaterate,
    Multilaterate3D,
    MultilateratePaired,
    build_locator_tables,
    locator_init,
    make_locate_update,
)
from onset_fingerprinting_torch.locate.calibration import (
    calibrate,
    calibration_locations,
    optimize_C,
    optimize_positions,
    tdoa_calib_loss,
    tdoa_calib_loss_with_sp,
    train_location_model,
)
