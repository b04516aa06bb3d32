"""The rule that holds the port's logistic CV (``utils/post_hoc.py``) to
scikit-learn's ``LogisticRegressionCV``, fold by fold.  Both stop scipy's
L-BFGS-B at a gradient of 1e-4, and a last-bit difference in a product
(BLAS rounding depends on the operands' alignment) can move where it stops.

Where scikit-learn's summed CV scores separate its two best Cs by more
than 1e-3, the port must choose scikit-learn's C.  Where both choose the
same C, the fold's AUCs agree within 1e-3.  A fold is excused only where
the two best scores lie within 1e-3 and the port chose another C.  Imports
scikit-learn; used by the tests only.
"""

import warnings

import numpy as np

TIE = 1e-3
AUC_TOL = 1e-3


def check_stratified_fold_aucs(X, y, got, want):
    """Hold ``got`` (the port's ``stratified_logit_cv_metrics(X, y)``) to
    ``want`` (the JAX package's, through scikit-learn) fold by fold under
    the rule above; returns the number of folds excused."""
    import sklearn.linear_model as lm
    import sklearn.model_selection as ms

    from multimodal_trajectory_modeling_tpu_torch.utils import post_hoc as pph
    from multimodal_trajectory_modeling_tpu_torch.utils import skl

    X, y = np.asarray(X, dtype=np.float64), np.asarray(y).ravel()
    folds = list(ms.StratifiedKFold(10, shuffle=True, random_state=42).split(X, y))
    assert len(got) == len(want) == len(folds)
    excused = 0
    for i, (tr, te) in enumerate(folds):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = lm.LogisticRegressionCV().fit(X[tr], y[tr])
        mine = pph.LogisticRegressionCV().fit(X[tr], y[tr])
        # the port's fold fit is the one its function made
        mine_auc = skl.roc_auc_score(y[te], mine.predict_proba(X[te])[:, 1])
        assert abs(mine_auc - got[i]) <= 1e-12, (i, mine_auc, got[i])
        summed = np.sort(ref.scores_[ref.classes_[1]].sum(axis=0))[::-1]
        if summed[0] - summed[1] > TIE:
            assert mine.C_ == ref.C_[0], (i, mine.C_, ref.C_[0])
        if mine.C_ == ref.C_[0]:
            assert abs(got[i] - want[i]) <= AUC_TOL, (i, got[i], want[i])
        else:
            excused += 1
    return excused
